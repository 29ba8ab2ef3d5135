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
//   gemm<GEGLU>    h . w1 -> act (M x F): each tile of BN columns holds BN / 2
//                  hidden units' h columns and their BN / 2 gate columns, so
//                  one thread holds both halves of each activation; F is
//                  ff_mult C rounded up to BN / 2 (the host pads w1's columns,
//                  b1 and w2's rows with zeros: GEGLU gives 0 there)
//   gemm<RESIDUAL> y += act . w2 + b2
//   gemm<RESIDUAL> out = y . w_out + b_out + x
// 6 + 4 n_attn launches (14 at two blocks); rows are the tokens in (b, t,
// s) order, M = B T S, with no padding.  The scratch rows are padded to a
// multiple of 8 elements (ldc = C rounded up, l3 = 3 C rounded up; a TMA
// row stride must be a multiple of 16 bytes): y, h (M x ldc) and qkv / act
// (M x max(l3, F)), allocated by the caller (ops/motion_module.py,
// torch.empty); the kernels allocate nothing and never read the pad
// columns.
//
// What bounds it, and the design.  The products are 44 C^2 of the
// 44 C^2 + 8 T C FLOPs a token at two blocks and ff_mult 4: at vitl m0
// 518x924 (C = 1024, 78,144 tokens) 3.67 ms at 989 TFLOP/s in bf16, 3 x the
// FLOPs at 495 TFLOP/s in 3xTF32.  Besides, the chain moves each activation
// through device memory (about 30 C bytes a token in bf16: 0.7 ms there at
// 3.35 TB/s, under the products' time when they overlap it).  The earlier GEMM
// was one 128 x 128 tile a CTA: each CTA's first TMA round trip and its
// epilogue (stores straight from the wgmma layout, half of each 32-byte
// sector, the residual read back the same way) ran with the tensor cores
// idle, and a 128 x 128 tile reads 64 FLOPs a byte from L2.  The GEMM is now
//   - persistent: one CTA an SM walks output tiles (tile_coords: grouped,
//     kGroupM row blocks a group, so one wave's A panels and weight column
//     blocks stay in L2), its producer warp keeping the ring full across
//     tile boundaries (the next tile's panels load during this one's
//     epilogue);
//   - on 128 x 256 tiles in bf16 (two consumer warpgroups, each wgmma
//     m64n256k16 with 128 fp32 accumulators a thread: 85 FLOPs a byte from
//     L2), 128 x 128 where N <= 128 (the small widths) and in fp32 (whose
//     hi and lo weight tiles leave no room for 256 columns beside a ring);
//   - with its epilogue written through shared memory and stored by TMA:
//     a storer warp copies the tile's biases into shared memory and
//     TMA-loads the residual into the output buffer during the tile's main
//     loop; the consumers add them, round, and write the tile into the
//     128-byte-swizzled buffer; the storer stores it with TMA while the
//     consumers start the next tile, and waits for the store to have read
//     the buffer before it loads the next residual.  The tensor cores idle
//     while the tile goes from registers to shared memory: the epilogues
//     still take 36-42 % of a product's time in bf16, 47-53 % in fp32 (the
//     split builds in PERF.md), more than their work explains.  Outputs
//     whose rows are not 16-byte aligned (proj_out at C not a multiple of
//     8 in bf16, 4 in fp32) store from registers as the earlier GEMM did, still
//     persistent and still fed across tiles (in fp32 that store from
//     registers was 40 % of the GEMM's time: the split).
// Built, timed and removed (PERF.md): a 2-CTA cluster multicasting each
// weight tile (within 5 % either way: L2 no longer bounds the products),
// and 128 x 128 tiles with two accumulator sets, the next tile's first
// panels started before the epilogue (slower: ptxas waits on the in-flight
// products there, and the smaller tile reads twice the weights a FLOP).
// The frame attention took 21-29 % of the earlier chain (the split in
// PERF.md): in bf16 it now runs on mma.sync over q, k and v staged in
// shared memory (wide_attention_mma, where d is a multiple of 16; else, and
// in fp32, the FFMA kernel).  The row norms (under 7 %) stay as they were.
//
// Ragged edges.  A GEMM's k panels past K (C not a multiple of 64 inputs,
// or 32 in fp32) come from the TMA's zero fill: the activation's tensor map
// has K columns, the box one whole panel.  Rows past M read as zero and are
// never stored (the TMA store clips them; the register epilogue skips
// them).  The weight tiles are zero-padded by the host to whole BN-column
// blocks and whole panels (ops/motion_module.wide_tiles); only columns < N
// are stored.
//
// Plan and shared memory (Plan<T, BN, STAGED>):
// - gemm: 320 threads: two consumer warpgroups of 64 rows each (one wgmma
//   M), a producer warp and a storer warp.  The producer streams, k panel
//   after k panel of tile after tile, the A panel (128 rows x 128 bytes, a
//   TMA box of the activation's tensor map, 128-byte swizzle) and the
//   weight tile of the panel (host-laid: BN output columns x 128 bytes of
//   inputs, the same swizzle; in fp32 a hi tile and a lo tile) into a ring
//   on full / empty mbarriers.  bf16: stage 48 KB at BN = 256 (3 stages
//   beside the 64 KB output buffer), 32 KB at BN = 128 (6 stages, 32 KB
//   buffer).  fp32: each thread loads its tf32 A fragments from the stage,
//   splits them (hi = rna(a), lo = rna(a - hi)) and runs lo.hi, hi.lo,
//   hi.hi (wgmma m64n64k8, two n64 halves); stage 48 KB, 3 stages beside
//   the 64 KB output buffer (4 without it).  One CTA an SM.
// - attention (wide_attention_mma: bf16, d a multiple of 16): one warp a
//   (location, head), up to 4 a CTA; else (wide_attention): one CTA a
//   location (b, s) and group of up to 8 heads, one
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
// Split builds (python -m video_depth_anything_torch.bench_motion_tail
// --wide): WIDE_SPLIT = 2 drops the loads (the producer and the storer
// arrive without copying), 3 the epilogues (nothing written), 4 the
// epilogues' TMA stores (the buffer written, never stored);
// vda_motion_module_wide_split times each launch with CUDA events between
// them.  (A build without the products, as the earlier chain was split, ran 3-5x slower than
// the whole GEMM here, its consumers spinning on the ring's barriers, and
// at the largest shapes outlasted mbar_wait's limit: not kept.)
#include <math.h>

#include <algorithm>

#include "motion_module.cuh"  // mm::gelu_bf16, and common.cuh / hopper.cuh

#ifndef WIDE_SPLIT
#define WIDE_SPLIT 0
#endif

namespace {

constexpr int kHeadsPerCta = 8;  // attention: heads a CTA
constexpr int BM = 128;  // rows of a GEMM tile: two consumer warpgroups of 64
constexpr int kGroupM = 8;  // the tile scheduler's row blocks a group (ops/motion_module.WIDE_GROUP_M)
constexpr int kGemmThreads = 2 * 128 + 2 * 32;  // consumers, the producer warp, the storer warp
constexpr int kRowThreads = 256;  // eight warps, one a row
constexpr int kSmemLimit = 232448;

// BN of a product of N output columns (ops/motion_module.wide_bn)
template <typename T>
constexpr int bn_of(int n) {
  return sizeof(T) == 2 && n > 128 ? 256 : 128;
}

template <typename T>
struct Op;
template <>
struct Op<bf16> {
  static constexpr int KW = 64;  // inputs of a k panel: 128 bytes a row
  static constexpr int W_ROW = 128;  // bytes of a weight tile row (an output column's panel)
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Op<float> {
  static constexpr int KW = 32;
  static constexpr int W_ROW = 256;  // the hi tile's row, then (BN rows on) the lo tile's
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// Shared memory of one GEMM instantiation: the ring, then (STAGED) the
// output buffer of BN / 64 boxes of 128 rows x 128 bytes and the tile's BN
// biases, then the barriers.
template <typename T, int BN, bool STAGED>
struct Plan {
  static constexpr int A_BYTES = BM * 128;  // a 128-row A panel
  static constexpr int B_BYTES = BN * Op<T>::W_ROW;  // a weight tile (fp32: hi then lo)
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BUF = STAGED ? BM * BN * static_cast<int>(sizeof(T)) : 0;
  static constexpr int BIAS = STAGED ? BN * 4 : 0;
  static constexpr int BAR = 256;
  static constexpr int NST = std::min(6, (kSmemLimit - 1024 - BUF - BIAS - BAR) / STAGE);
  static constexpr int SMEM = NST * STAGE + BUF + BIAS + BAR + 1024;
  static_assert(NST >= 3 && SMEM <= kSmemLimit, "shared memory over the opt-in limit");
};

enum Epi { kBias = 0, kResidual = 1, kGeglu = 2 };

struct GemmArgs {
  const void* w;      // this product's tiles: ceil(N / BN) column blocks x ceil(K / KW) panels
  const float* bias;  // nullptr: none
  const void* res;    // kResidual, register epilogue: added, (M, ldo), may be out itself
  void* out;          // (M, ldo); columns n < N stored
  int M, K, N, ldo;
};

// The output tile of a persistent CTA's walk: tiles in groups of kGroupM
// row blocks, column block after column block within a group, the rows of
// a group before the next column (ops/motion_module.wide_tile).
__device__ __forceinline__ void tile_coords(int tile, int nm, int nn, int& mb, int& nb) {
  const int per_group = kGroupM * nn;
  const int group = tile / per_group, first = group * kGroupM;
  const int rows = min(nm - first, kGroupM);
  const int r = tile - group * per_group;
  mb = first + r % rows;
  nb = r / rows;
}

// ---- TMA stores and 2-D loads (the staged epilogue) ----
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the committed stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// D[64 x 256] (+)= A[64 x 16] B^T, B[256 x 16]: both K-major in shared
// memory (descriptors); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

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


// acc (m64nBN: d[4t + 0..1] = (row g, cols 8t + 2c..), d[4t + 2..3] = (row
// g + 8, same)) += the warpgroup's 64 rows of A . the stage's weight tile^T
// over one k panel.  bf16: four k16 steps, A and B from shared memory.
template <int BN>
__device__ __forceinline__ void panel(float (&acc)[BN / 2], const unsigned char* st, int wg,
                                      int first) {
  const uint64_t da = desc_sw128(st + wg * 64 * 128);
  const uint64_t db = desc_sw128(st + BM * 128);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int sd = (first && ks == 0) ? 0 : 1;
    if constexpr (BN == 256)
      wgmma_ss_n256(acc, da + 2 * ks, db + 2 * ks, sd);
    else
      wgmma_ss_n128(acc, da + 2 * ks, db + 2 * ks, sd);
  }
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
  const float* bh = reinterpret_cast<const float*>(st + BM * 128);
  const float* bl = bh + 128 * 32;
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

// Byte offset of element (r, col) in the staged output buffer: box col / E
// of 128 rows x 128 bytes (E = 64 bf16 or 32 floats a row), 16-byte chunk
// ((col % E) / (E / 8)) ^ (r % 8) of row r (the TMA's 128-byte swizzle).
template <typename T>
__device__ __forceinline__ int buf_off(int r, int col) {
  constexpr int E = 128 / sizeof(T), CH = E / 8;  // elements a row, a chunk
  return (col / E) * (BM * 128) + r * 128 + ((((col % E) / CH) ^ (r & 7)) << 4) +
         (col % CH) * static_cast<int>(sizeof(T));
}

// The epilogue of one tile from its accumulators (tile rows m0 + local row
// `rl` and rl + 8, columns 8 t + c2 + 0..1 of the tile), into the staged
// buffer `buf` (STAGED: the residual already there, stored later by TMA; the
// tile's biases in `sb`, the GEGLU tile's gate biases BN / 2 on) or
// straight to device memory.
template <typename T, int EPI, int BN, bool STAGED>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const GemmArgs& g,
                                         unsigned char* buf, const float* sb, int mb, int nb,
                                         int rl, int c2) {
  const bool pairs = !(g.ldo & 1);  // every row start 2-aligned
  T* out = static_cast<T*>(g.out);
  const T* res = static_cast<const T*>(g.res);
  if constexpr (EPI == kGeglu) {
    // columns 0..BN/2-1 of the tile: hidden units BN/2 nb + j's h; the rest
    // their gate; F = ldo a multiple of BN / 2: every unit stored
    const int ff = g.ldo;  // F: the gate biases follow the h biases
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) {
      const int jl = 8 * t + c2, j = nb * (BN / 2) + jl;
      const float2 bh = *reinterpret_cast<const float2*>(STAGED ? sb + jl : g.bias + j);
      const float2 bg =
          *reinterpret_cast<const float2*>(STAGED ? sb + BN / 2 + jl : g.bias + ff + j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h, row = mb * BM + r;
        if (!STAGED && row >= g.M) continue;
        const float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
        const float g0 = acc[4 * (t + BN / 16) + 2 * h], g1 = acc[4 * (t + BN / 16) + 2 * h + 1];
        float a0, a1;
        if constexpr (sizeof(T) == 2) {
          a0 = bf16_round(v0 + bh.x) * mm::gelu_bf16(bf16_round(g0 + bg.x));
          a1 = bf16_round(v1 + bh.y) * mm::gelu_bf16(bf16_round(g1 + bg.y));
        } else {
          a0 = (v0 + bh.x) * gelu_erf(g0 + bg.x);
          a1 = (v1 + bh.y) * gelu_erf(g1 + bg.y);
        }
        if constexpr (STAGED)
          store2(reinterpret_cast<T*>(buf + buf_off<T>(r, jl)), a0, a1);
        else
          store2(out + (long long)row * g.ldo + j, a0, a1);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const int nl = 8 * t + c2, n = nb * BN + nl;
      if (!STAGED && n >= g.N) continue;  // past the product's columns: nothing stored
      float2 b = make_float2(0.f, 0.f);
      if (STAGED) b = *reinterpret_cast<const float2*>(sb + nl);
      else if (g.bias && n + 1 < g.N) b = *reinterpret_cast<const float2*>(g.bias + n);
      else if (g.bias && n < g.N) b.x = g.bias[n];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h, row = mb * BM + r;
        if (!STAGED && row >= g.M) continue;
        const float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
        if constexpr (STAGED) {
          T* p = reinterpret_cast<T*>(buf + buf_off<T>(r, nl));
          if constexpr (EPI == kResidual) {
            const float2 y = load2(p);
            if constexpr (sizeof(T) == 2)
              store2(p, y.x + v0 + b.x, y.y + v1 + b.y);
            else
              store2(p, y.x + (v0 + b.x), y.y + (v1 + b.y));
          } else {
            store2(p, v0 + b.x, v1 + b.y);
          }
        } else {
          const long long ro = (long long)row * g.ldo;
          if constexpr (EPI == kResidual) {
            const float2 y = get2(res + ro, n, g.N, pairs);
            if constexpr (sizeof(T) == 2)
              put2(out + ro, n, g.N, pairs, y.x + v0 + b.x, y.y + v1 + b.y);
            else
              put2(out + ro, n, g.N, pairs, y.x + (v0 + b.x), y.y + (v1 + b.y));
          } else {
            put2(out + ro, n, g.N, pairs, v0 + b.x, v1 + b.y);
          }
        }
      }
    }
  }
}

// out = A . W with the epilogue EPI over every output tile, persistent: CTA
// b takes tiles b, b + gridDim.x, ... in tile_coords' order.  A is amap's
// (M, K) activation; STAGED: omap the output's (N, M) map and rmap the
// residual's (kResidual), boxes of 64 columns x 128 rows.
template <typename T, int EPI, int BN, bool STAGED>
__global__ void __launch_bounds__(kGemmThreads, 1)
    wide_gemm(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap rmap, const GemmArgs g) {
  using P = Plan<T, BN, STAGED>;
  constexpr int NST = P::NST, STAGE = P::STAGE, KW = Op<T>::KW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* buf = base + NST * STAGE;
  float* sbias = reinterpret_cast<float*>(buf + P::BUF);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + P::BUF + P::BIAS);
  uint64_t* empty = full + NST;
  uint64_t* ready = empty + NST;  // storer -> consumers: the buffer is free (the residual in it)
  uint64_t* done = ready + 1;     // consumers -> storer: the tile is in the buffer
  const int kpn = (g.K + KW - 1) / KW, nm = (g.M + BM - 1) / BM, nn = (g.N + BN - 1) / BN;
  const int ntiles = nm * nn;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // both consumer warpgroups
    }
    mbar_init(ready, 1);
    mbar_init(done, 1);  // one consumer thread, after the consumers' named barrier
    fence_mbar_init();
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (warp == 8) {  // the producer: one thread streams the panels, tile after tile
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int mb, nb;
        tile_coords(tile, nm, nn, mb, nb);
        const unsigned char* wsrc =
            static_cast<const unsigned char*>(g.w) + (long long)nb * kpn * P::B_BYTES;
        for (int kp = 0; kp < kpn; ++kp, ++it) {
          const int s = it % NST;
          if (it >= NST) mbar_wait(&empty[s], (it / NST - 1) & 1);
#if WIDE_SPLIT == 2
          mbar_arrive(&full[s]);
#else
          mbar_arrive_expect_tx(&full[s], STAGE);
          tma_load_3d(base + s * STAGE, &amap, &full[s], kp * KW, mb * BM, 0);
          bulk_load(base + s * STAGE + P::A_BYTES, wsrc + (long long)kp * P::B_BYTES, P::B_BYTES,
                    &full[s]);
#endif
        }
      }
    }
  } else if (warp == 9) {  // the storer: biases and residual tiles in, finished tiles out (TMA)
    if constexpr (STAGED) {
      constexpr int OUT_COLS = EPI == kGeglu ? BN / 2 : BN;
      const int ncols = EPI == kGeglu ? g.ldo : g.N;
      int j = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++j) {
        int mb, nb;
        tile_coords(tile, nm, nn, mb, nb);
        const int n0 = nb * OUT_COLS, m0 = mb * BM;
        constexpr int BOXC = 128 / sizeof(T);  // a box's columns
        const int boxes = min(OUT_COLS, ncols - n0 + BOXC - 1) / BOXC;  // boxes that start below N
        // the tile's biases (zeros past N; GEGLU: the h biases, then the
        // gates' from F on), read by the consumers from shared memory
        for (int i = lane; i < BN; i += 32) {
          float b = 0.f;
          if constexpr (EPI == kGeglu) b = g.bias[(i < BN / 2 ? 0 : g.ldo - BN / 2) + n0 + i];
          else if (g.bias != nullptr && n0 + i < g.N) b = g.bias[n0 + i];
          sbias[i] = b;
        }
        __syncwarp();
        if (lane == 0) {
          if (j > 0) bulk_wait_read();  // the last store is done with the buffer
          if (EPI == kResidual && WIDE_SPLIT != 2 && WIDE_SPLIT != 3) {
            mbar_arrive_expect_tx(ready, boxes * BM * 128);
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(buf + b * BM * 128, &rmap, ready, n0 + BOXC * b, m0);
          } else {
            mbar_arrive(ready);
          }
        }
        mbar_wait(done, j & 1);  // every lane: the biases are read
#if WIDE_SPLIT != 3 && WIDE_SPLIT != 4
        if (lane == 0) {
          for (int b = 0; b < boxes; ++b)
            tma_store_2d(&omap, buf + b * BM * 128, n0 + BOXC * b, m0);
          bulk_commit();
        }
#endif
      }
      if (lane == 0) bulk_wait();
    }
  } else {  // the consumers
    const int wg = warp >> 2;
    const bool leader = (threadIdx.x & 127) == 0;
    const int rl = wg * 64 + (warp & 3) * 16 + (lane >> 2), c2 = 2 * (lane & 3);
    const auto release = [&](int s) {  // this warpgroup is done with stage s
      if (leader) mbar_arrive(&empty[s]);
    };
    float acc[BN / 2];
    int it = 0, j = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++j) {
      int mb, nb;
      tile_coords(tile, nm, nn, mb, nb);
      for (int kp = 0; kp < kpn; ++kp, ++it) {
        const int s = it % NST;
        mbar_wait(&full[s], (it / NST) & 1);
        if constexpr (sizeof(T) == 2) {
          panel<BN>(acc, base + s * STAGE, wg, kp == 0);
          if (kp > 0) {
            wgmma_wait<1>();  // panel kp - 1's products are done with its stage
            release((it - 1) % NST);
          }
        } else {
          panel_f32(acc, base + s * STAGE, wg, kp == 0);
          release(s);
        }
      }
      if constexpr (sizeof(T) == 2) {
        wgmma_wait<0>();
        release((it - 1) % NST);
      }
      fence_regs(acc);
      if constexpr (STAGED) {
        mbar_wait(ready, j & 1);  // the buffer is free, the residual in it
#if WIDE_SPLIT != 3
        epilogue<T, EPI, BN, true>(acc, g, buf, sbias, mb, nb, rl, c2);
#endif
        fence_async_smem();  // the writes, before the storer's TMA reads them
        bar_sync(1, 256);    // every consumer's writes (one arrival, not 256 on one barrier)
        if (threadIdx.x == 0) mbar_arrive(done);
      } else {
#if WIDE_SPLIT != 3
        epilogue<T, EPI, BN, false>(acc, g, buf, sbias, mb, nb, rl, c2);
#endif
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


// bf16 frame attention on the tensor cores (d a multiple of 16): one warp a
// (location, head) item, kAttnWarps warps a CTA (fewer where d is wide).
// The warp copies its item's q, k and v rows of the TQ frames (T rounded up
// to 16 or 32; rows t >= T zero) from the qkv scratch into shared memory
// with cp.async (16 bytes a lane: a head's row is d contiguous elements;
// rows of d + 8 elements, so that ldmatrix's eight rows fall on distinct
// banks), then S = q k^T by mma.sync m16n8k16 (q and k through ldmatrix),
// the softmax in registers (a row's TQ scores over the four lanes of a
// quad; keys t >= T masked; p = bf16(e / sum) as the bf16 Kernel C rounds
// it), and O = P . V by mma.sync with P from the S accumulators and V
// through ldmatrix.trans, 64 output columns at a time, rounded to bf16 and
// stored for the query frames t < T.
constexpr int kAttnWarps = 4;

template <int TQ>
__global__ void __launch_bounds__(kAttnWarps * 32)
    wide_attention_mma(const bf16* __restrict__ qkv, bf16* __restrict__ dst, int nT, int S, int C,
                       int heads, int l3, int ldc, float scale, int items) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const int d = C / heads, ld = d + 8;  // shared rows: d + 8 elements
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= items) return;
  const int hd = item % heads, loc = item / heads, b = loc / S, s = loc % S;
  bf16* sq = reinterpret_cast<bf16*>(attn_smem) + (long long)warp * 3 * TQ * ld;
  bf16* sk = sq + TQ * ld;
  bf16* sv = sk + TQ * ld;
  {  // q, k, v rows of the frames: 16-byte chunks, lane after lane
    const int per_row = d / 8, per_mat = TQ * per_row;
    const long long fs = (long long)S * l3;  // one frame on
    const bf16* src0 = qkv + ((long long)b * nT * S + s) * l3 + hd * d;
    for (int i = lane; i < 3 * per_mat; i += 32) {
      const int mat = i / per_mat, r = (i % per_mat) / per_row, ch = i % per_row;
      bf16* dstp = sq + (mat * TQ + r) * ld + ch * 8;
      if (r < nT) {
        const bf16* srcp = src0 + r * fs + mat * C + ch * 8;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dstp)),
                     "l"(srcp)
                     : "memory");
      } else {
        *reinterpret_cast<uint4*>(dstp) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
  }
  constexpr int MT = TQ / 16, NT = TQ / 8;
  const int g = lane >> 2, c = lane & 3;
  // S = q k^T: MT x NT tiles of 16 x 8
  float sc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[mi][ni][i] = 0.f;
  for (int ks = 0; ks < d / 16; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      ldmatrix_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                  sq + (16 * mi + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3,
                  sk + (16 * np + (lane & 7) + (lane >> 4) * 8) * ld + 16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16_16816(sc[mi][2 * np], a[mi], b0, b1);
        mma_bf16_16816(sc[mi][2 * np + 1], a[mi], b2, b3);
      }
    }
  }
  // softmax over the keys of each query row (rows g and g + 8 of each m tile)
  uint32_t pa[MT][TQ / 16][4];  // P as the A fragments of P . V
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * ni + 2 * c + e;
          float& v = sc[mi][ni][2 * hh + e];
          v = key < nT ? v * scale : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * ni + 2 * c + e;
          float& v = sc[mi][ni][2 * hh + e];
          v = key < nT ? __expf(v - mx) : 0.f;
          sum += v;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[mi][ni][2 * hh + e] *= inv;
    }
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      pa[mi][kk][0] = pack_bf16x2(sc[mi][2 * kk][0], sc[mi][2 * kk][1]);
      pa[mi][kk][1] = pack_bf16x2(sc[mi][2 * kk][2], sc[mi][2 * kk][3]);
      pa[mi][kk][2] = pack_bf16x2(sc[mi][2 * kk + 1][0], sc[mi][2 * kk + 1][1]);
      pa[mi][kk][3] = pack_bf16x2(sc[mi][2 * kk + 1][2], sc[mi][2 * kk + 1][3]);
    }
  }
  // O = P . V, 64 columns at a time
  bf16* out = dst + ((long long)b * nT * S + s) * ldc + hd * d;
  const long long os = (long long)S * ldc;  // one frame on
  for (int c0 = 0; c0 < d; c0 += 64) {
    float o[MT][8][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mi][nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (c0 + 16 * np >= d) break;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          sv + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + 16 * np +
                              (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16_16816(o[mi][2 * np], pa[mi][kk], b0, b1);
          mma_bf16_16816(o[mi][2 * np + 1], pa[mi][kk], b2, b3);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c0 + 8 * nt + 2 * c;
        if (col >= d) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = 16 * mi + g + 8 * hh;
          if (t < nT)
            *reinterpret_cast<uint32_t*>(out + t * os + col) =
                pack_bf16x2(o[mi][nt][2 * hh], o[mi][nt][2 * hh + 1]);
        }
      }
  }
}

struct Args {
  const void *x, *gna, *gnb, *pe, *w, *b_in, *ln_s, *ln_b, *bo, *b1, *b2, *b_out;
  void *out, *scratch;
  int B, T, S, C;
  float scale, ln_eps;
  int heads, n_attn, F;  // F: the hidden units, ff_mult C rounded up (ops/motion_module.wide_hidden)
};

constexpr int round8(int n) { return (n + 7) / 8 * 8; }

template <typename T, int EPI, int BN, bool STAGED>
int set_smem1() {
  return static_cast<int>(cudaFuncSetAttribute(wide_gemm<T, EPI, BN, STAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Plan<T, BN, STAGED>::SMEM));
}

template <typename T>
int set_smem() {
  int e = 0;
  if constexpr (sizeof(T) == 2) {
    if ((e = set_smem1<T, kBias, 128, true>()) || (e = set_smem1<T, kBias, 256, true>()) ||
        (e = set_smem1<T, kGeglu, 128, true>()) || (e = set_smem1<T, kGeglu, 256, true>()) ||
        (e = set_smem1<T, kResidual, 128, true>()) || (e = set_smem1<T, kResidual, 256, true>()) ||
        (e = set_smem1<T, kResidual, 128, false>()) || (e = set_smem1<T, kResidual, 256, false>()))
      return e;
  } else {
    if ((e = set_smem1<T, kBias, 128, true>()) || (e = set_smem1<T, kGeglu, 128, true>()) ||
        (e = set_smem1<T, kResidual, 128, true>()) || (e = set_smem1<T, kResidual, 128, false>()))
      return e;
  }
  return 0;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
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

// the (M, N) output (or residual) at `p`, rows `ld` elements apart (16-byte
// aligned rows), as the 2-D map (N, M) of boxes of 128 bytes of columns x
// 128 rows (128-byte swizzle): the staged epilogue's buffer layout; columns
// past N and rows past M are not stored (read as zeros)
template <typename T>
bool tile_map(CUtensorMap* map, const void* p, int M, int N, int ld) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {128 / sizeof(T), static_cast<cuuint32_t>(BM)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, Op<T>::kMap, 2, const_cast<void*>(p), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product: BN from N (bn_of), the staged epilogue where `staged` (omap
// / rmap valid), a persistent grid of at most one CTA an SM.
template <typename T, int EPI, int BN, bool STAGED>
int launch(const CUtensorMap& amap, const CUtensorMap& omap, const CUtensorMap& rmap,
           const GemmArgs& g, cudaStream_t st) {
  const int tiles = (g.M + BM - 1) / BM * ((g.N + BN - 1) / BN);
  wide_gemm<T, EPI, BN, STAGED><<<std::min(tiles, num_sms()), kGemmThreads,
                                  Plan<T, BN, STAGED>::SMEM, st>>>(amap, omap, rmap, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPI>
int gemm(const CUtensorMap& amap, const CUtensorMap& omap, const CUtensorMap& rmap,
         const GemmArgs& g, bool staged, cudaStream_t st) {
  constexpr int BW = sizeof(T) == 2 ? 256 : 128;  // T's widest tile
  const bool wide = bn_of<T>(g.N) == BW;
  if (staged)
    return wide ? launch<T, EPI, BW, true>(amap, omap, rmap, g, st)
                : launch<T, EPI, 128, true>(amap, omap, rmap, g, st);
  if constexpr (EPI == kResidual)  // the output's rows not 16-byte aligned
    return wide ? launch<T, EPI, BW, false>(amap, omap, rmap, g, st)
                : launch<T, EPI, 128, false>(amap, omap, rmap, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
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

// Shared memory of the tensor-core frame attention's CTA of `warps` warps.
int attn_mma_smem(int tq, int d, int warps) { return warps * 3 * tq * (d + 8) * 2; }

template <typename T>
int attention(const T* qkv, T* dst, const Args& a, int l3, int ldc, cudaStream_t st) {
  const int d = a.C / a.heads, tq = a.T <= 16 ? 16 : 32;
  if constexpr (sizeof(T) == 2) {
    int warps = kAttnWarps;
    while (warps > 1 && attn_mma_smem(tq, d, warps) > kSmemLimit) --warps;
    if (d % 16 == 0 && attn_mma_smem(tq, d, warps) <= kSmemLimit) {
      const int items = a.B * a.S * a.heads, smem = attn_mma_smem(tq, d, warps);
      const auto go = [&](auto kern) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kSmemLimit);
        if (e != cudaSuccess) return static_cast<int>(e);
        kern<<<(items + warps - 1) / warps, warps * 32, smem, st>>>(
            qkv, dst, a.T, a.S, a.C, a.heads, l3, ldc, a.scale, items);
        return static_cast<int>(cudaGetLastError());
      };
      return tq == 16 ? go(wide_attention_mma<16>) : go(wide_attention_mma<32>);
    }
  }
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
// and BN-column blocks
template <typename T>
constexpr long long tile_bytes(long long k, long long n) {
  const int bn = bn_of<T>(static_cast<int>(n));
  return (n + bn - 1) / bn * ((k + Op<T>::KW - 1) / Op<T>::KW) * bn * Op<T>::W_ROW;
}

// Launch marks of the split entry: CUDA events recorded after each launch
// (wide_nev < 0: none).
constexpr int kMarks = 64;
cudaEvent_t wide_ev[kMarks + 1];
int wide_nev = -1;
void wide_mark(cudaStream_t st) {
  if (wide_nev >= 0 && wide_nev <= kMarks) cudaEventRecord(wide_ev[wide_nev++], st);
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
  // the staged epilogues' maps: y, q | k | v, the activation, and x / out
  // where their rows are 16-byte aligned
  CUtensorMap oy{}, oqkv{}, oact{}, ox{}, oout{};
  const bool xal = C * sizeof(T) % 16 == 0;
  if (!tile_map<T>(&oy, y, M, C, ldc) || !tile_map<T>(&oqkv, big, M, 3 * C, l3) ||
      !tile_map<T>(&oact, big, M, F, F) ||
      (xal && (!tile_map<T>(&ox, a.x, M, C, C) || !tile_map<T>(&oout, a.out, M, C, C))))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned char* w = static_cast<const unsigned char*>(a.w);
  const float* ln_s = static_cast<const float*>(a.ln_s);
  const float* ln_b = static_cast<const float*>(a.ln_b);
  const float* bo = static_cast<const float*>(a.bo);
  const T* pe = static_cast<const T*>(a.pe);
  wide_mark(st);
#define VDA_WIDE_CHECK(call) \
  if ((e = (call)) != 0) return e; \
  wide_mark(st);
  VDA_WIDE_CHECK((rows<T, false>(static_cast<const T*>(a.x), h, static_cast<const float*>(a.gna),
                                 static_cast<const float*>(a.gnb), nullptr, a, M, C, ldc, 0.f, st)));
  VDA_WIDE_CHECK((gemm<T, kBias>(mh, oy, oy, GemmArgs{w, static_cast<const float*>(a.b_in), nullptr, y, M, C, C, ldc}, true, st)));
  w += tile_bytes<T>(C, C);
  for (int i = 0; i < a.n_attn; ++i) {
    VDA_WIDE_CHECK((rows<T, true>(y, h, ln_s + i * C, ln_b + i * C, pe, a, M, ldc, ldc, a.ln_eps, st)));
    VDA_WIDE_CHECK((gemm<T, kBias>(mh, oqkv, oqkv, GemmArgs{w, nullptr, nullptr, big, M, C, 3 * C, l3}, true, st)));
    w += tile_bytes<T>(C, 3 * C);
    VDA_WIDE_CHECK((attention<T>(big, h, a, l3, ldc, st)));
    VDA_WIDE_CHECK((gemm<T, kResidual>(mh, oy, oy, GemmArgs{w, bo + i * C, y, y, M, C, C, ldc}, true, st)));
    w += tile_bytes<T>(C, C);
  }
  VDA_WIDE_CHECK((rows<T, true>(y, h, ln_s + a.n_attn * C, ln_b + a.n_attn * C, nullptr, a, M, ldc,
                                ldc, a.ln_eps, st)));
  VDA_WIDE_CHECK((gemm<T, kGeglu>(mh, oact, oact, GemmArgs{w, static_cast<const float*>(a.b1), nullptr, big, M, C, 2 * F, F}, true, st)));
  w += tile_bytes<T>(C, 2 * F);
  VDA_WIDE_CHECK((gemm<T, kResidual>(mact, oy, oy, GemmArgs{w, static_cast<const float*>(a.b2), y, y, M, F, C, ldc}, true, st)));
  w += tile_bytes<T>(F, C);
  VDA_WIDE_CHECK((gemm<T, kResidual>(my, oout, ox, GemmArgs{w, static_cast<const float*>(a.b_out), a.x, a.out, M, C, C, C}, xal, st)));
#undef VDA_WIDE_CHECK
  return 0;
}

template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  if (a.T < 8 || a.T > 32 || a.C < 1 || a.heads < 1 || a.C % a.heads || a.n_attn < 1 ||
      a.F < 64 || a.F % (bn_of<T>(2 * a.F) / 2))
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
// divide C; F a multiple of 64 (of 128 where the bf16 GEGLU tile is 256
// columns wide: ops/motion_module.wide_hidden).
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

// The chain's time by launch (bench_motion_tail --wide, chip_smoke.py):
// `iters` runs after a warm one, CUDA events between the launches; ms[i] the
// mean ms of launch i, -1 past the last.  Not counted as launches.
extern "C" int vda_motion_module_wide_split(VDA_WIDE_ARGS, int f32, int iters, float* ms) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (auto& ev : wide_ev)
    if (ev == nullptr && cudaEventCreate(&ev) != cudaSuccess) return 1;
  for (int i = 0; i < kMarks; ++i) ms[i] = 0.f;
  int n = 0;
  for (int it = 0; it <= iters; ++it) {  // the first run warms up
    wide_nev = 0;
    const int e = f32 ? dispatch<float>(VDA_WIDE_STRUCT, st) : dispatch<bf16>(VDA_WIDE_STRUCT, st);
    n = wide_nev - 1;
    wide_nev = -1;
    if (e) return e;
    const cudaError_t se = cudaEventSynchronize(wide_ev[n]);
    if (se != cudaSuccess) return static_cast<int>(se);
    for (int i = 0; it > 0 && i < n; ++i) {
      float t = 0.f;
      cudaEventElapsedTime(&t, wide_ev[i], wide_ev[i + 1]);
      ms[i] += t / iters;
    }
  }
  for (int i = n; i < kMarks; ++i) ms[i] = -1.f;
  return 0;
}
