// Kernel A's probes on Hopper (sm_90a): the spatial probes ilv / nomask,
// chunk<k> and sbf16 / sbf16:fast / ceiling, and the softmax-chain probe.
//
// Replaces scripts/bench_spatial_variants.py:_kernel_ilv (variants ilv and
// nomask), _kernel_chunk (chunk<k>) and _kernel_sbf16 (sbf16, sbf16:fast,
// ceiling), launched by run_variant, and scripts/bench_softmax_chain.py
// make_kernel's kern (chain_hopper, at the end).  The spatial probes'
// numerics are the TPU kernels' (ops/attention_variants.spatial_kernel_plain):
//   * q is prescaled by scale*log2(e) in fp32 and rounded to bf16 before
//     Q K^T.  TMA lands q raw; each warpgroup scales its own rows in shared
//     memory once per Q tile and fences the writes for wgmma.
//   * keys run to n_pad = round_up(n, 128); TMA zero-fills rows >= n, so a
//     pad key scores exactly 0.  ilv masks keys >= n to -1e30 (p = 0);
//     nomask and chunk do not mask and take (n_pad - n) off l, as the TPU
//     kernels do (p = exp2_poly(0) = 1.00000526 per pad key).
//   * fp32 scores, no row max, exp2_poly on the FMA units (not MUFU: that is
//     the question the probes ask), P rounded to bf16 before P V, fp32
//     accumulate, out = acc / l.
//   * sbf16 rounds each fp32 score to bf16 (round to nearest even, as the
//     TPU's astype and torch's cast) and masks keys >= n to bf16(-1e30);
//     exact mode then takes x = bf16(s - m), m the row's GLOBAL max of the
//     bf16 scores, sbf16:fast x = s; p = exp2_poly(x).  ceiling is p = bf16(s)
//     with no mask and l = n_pad.
//
// exp2_poly is the TPU's _exp2_poly (pallas_attention.py:54-74) with the
// floor and the exponent taken without conversions: t = x + 1.5 * 2^23
// added rounding down is floor(x) + 1.5 * 2^23 exactly (|x| < 2^22), its
// low mantissa bits are floor(x), and t - 1.5 * 2^23 is floor(x) as a float.
// Clamping x at -127 in place of -200 and the integer exponent at 127
// gives the same bits everywhere in that range (every x < -126 has a
// biased exponent <= 0, clamped to 0: p = 0).  floorf and __float2int_rz
// are conversions, 16 a clock on an SM against 128 fp32 operations; with
// them the chain, not the tensor cores, bounds these kernels (PERF.md
// section 6, step 0: about 2.5 conversions a score, 0.6 ms at vitl).
//
// Bound on the H100.  Tensor-core FLOPs: 4 * n^2 * 64 * H * B (vitl 32 x
// 1370 x 16 heads: 0.2487 ms at 989 TFLOP/s; vits 6 heads: 0.0933).  The
// chain: about 14 instructions a score (10 fp32, 3 integer, half a
// conversion for the bf16 pack), issued at 128 a clock on an SM, over
// 32 * H * 1408^2 scores: ~0.4 ms at vitl, more than the tensor bound.  So
// the design overlaps the chain with the products: wgmma is asynchronous,
// and the TPU kernels' program order becomes real overlap with
// wgmma.wait_group<1> (or <2>) in place of <0>.
//
// Both kernels: a CTA is two warpgroups of 64 query rows each (256
// threads), fed by TMA through an mbarrier ring; there is no producer
// warp.  Whichever warpgroup releases a ring stage second (both have
// waited for the products that read it; a shared-memory count decides)
// issues the TMA loads that refill it.  A third warpgroup, or a third
// warp, would make ptxas budget 65536 / 384 = 168 registers a thread,
// setmaxnreg or not, and at 168 it serialised these kernels' products for
// want of registers; at 256 threads the budget is 255.  S = Q K^T is
// wgmma m64n64k16 with both operands K-major in shared memory; P V is
// wgmma m64n64k16 with P packed to bf16 A fragments in registers (the
// accumulator is the mma.m16n8 C layout) and V MN-major (transpose bit).
// Keys come in 64-key tiles.  Every wait_group count is a constant in
// straight-line code: a count chosen at run time, or a branch between a
// product and its wait, also made ptxas serialise the products.
//
//   ilv_hopper<NOMASK>  a CTA is (128 query rows, head pair, batch); each
//                       warpgroup holds both heads of the pair.  Q of both
//                       heads (32 KB) is loaded once; a ring stage holds K0,
//                       K1, V0, V1 of one key tile (32 KB, 4 stages).  Per
//                       key tile, in the TPU's order: S0 and S1 issued as
//                       two groups; wait<1> and head 0's chain while S1
//                       runs; P0 V0 issued; wait<1> and head 1's chain
//                       while P0 V0 runs; P1 V1 issued.  P0 stays in its
//                       own registers until the next tile's wait shows
//                       P0 V0 done.  A stage is released while the next
//                       tile but one waits for its S0.  The key mask of
//                       ilv runs on the last tiles only, in a loop of
//                       their own.
//   sbf16_hopper<FAST, CEILING>  ilv_hopper's CTA, ring and per-tile order.
//                       Because s - m is rounded to bf16, an online max with
//                       a rescale would compute another function, so exact
//                       mode takes two passes over the keys through one ring:
//                       pass 1 streams K alone (a stage is filled with K0, K1
//                       and released after both S products are waited for)
//                       and takes the row max of the fp32 scores, rounded to
//                       bf16 once at the end (rounding is monotonic, so that
//                       is the max of the bf16 scores; masked keys are left
//                       out); pass 2 streams K and V and runs the chain and
//                       P V.  The ring's loads are one sequence over both
//                       passes.  A score is rounded by cvt.rn.bf16x2.f32 on
//                       a pair and the halves shifted back (half a
//                       conversion and one integer operation a score; the
//                       integer round-to-nearest-even takes four integer
//                       operations, on a pipe of half the fp32 rate).
//   chunk_hopper        the TPU's three-stage pipeline QK(i) | chain(i-1) |
//                       P V(i-2) over the flat sequence of (stream, key
//                       tile) steps, double-buffered S and P in registers.
//                       A CTA covers nc chunks of 128 rows of one head pair
//                       (each warpgroup one 64-row half of each chunk):
//                       2 * nc streams in head-major order (stream = head *
//                       nc + chunk, bench_spatial_variants.py:89-90), each
//                       over every key tile; chunks wholly past n are
//                       dropped.  The pipeline crosses stream boundaries:
//                       a stream's output leaves at the wait that shows
//                       its last P V done, before the next stream's first
//                       P V overwrites the accumulator.  Q goes through
//                       two slots, one per stream in flight; K and V of a
//                       step share a 16 KB ring stage (8 stages), released
//                       after S(i+4) is issued (P V(i) is done by then).  The
//                       chain of step i-1 runs while S(i) and P V(i-3)
//                       are on the tensor cores (wait<2>); P(i-1) is
//                       packed once P V(i-3), which read that P slot, is
//                       done (wait<1>).
//
// chain_hopper<MODE>  kern's seven chains (gemms, exp, exact, sexp,
//   pexp, bf16s, bf16x) on q, k (BH, N, 64) and v (BH, Nk, Dv): fp32 scores,
//   no mask (Nk a multiple of 64), P rounded to bf16 before P V, fp32
//   accumulate, the unnormalised (P V)[:, :64]; every mode takes the
//   mma.sync kernel's intrinsics (exp2f, __expf, the bit tricks), and bf16
//   rounding by cvt.rn on pairs.  exact keeps an online max with rescale;
//   bf16x rounds s - m to bf16, so it takes the global max of the scores
//   in a first pass over K (rounded once: rounding is monotonic).
//   Bound: the tensor cores, 4 * BH * Nq * Nk * 64 FLOP (0.257 ms at
//   512 x 1376 x 1408), and MUFU for the modes with a hardware
//   exponential (one a score, 0.24 ms); what held the mma.sync kernel was
//   its products (4x the tensor bound) and each 64-row CTA reading its
//   batch-head's K and V whole (4.06 GB a call at Nq = 1376).
//   Design: Kernel A's skeleton.  A CTA is 128 query rows of one
//   batch-head: a producer warpgroup (setmaxnreg 24) whose one thread
//   keeps TMA loads in flight, and two consumer warpgroups (240) of 64
//   rows.  The ring's stage is the K tile and V's first 64 columns of 64
//   keys (16 KB, 6 stages); V's map is the (BH, Nk, 1, 64) view of row
//   stride Dv, so nothing is copied.  S = Q K^T on wgmma m64n64k16 from
//   shared memory, P V on wgmma m64n64k16 with P in registers.  Per key
//   tile j a consumer issues S(j + 1), runs the chain of tile j while
//   S(j + 1) and P V(j - 1) are on the tensor cores, then issues P V(j).
//   Each CTA loads its own K and V tiles: a cluster of two CTAs sharing
//   them by TMA multicast was built and timed, and lost in every mode
//   (PERF.md section 6: its loads alone took 0.43 ms against 0.31 for
//   twice the bytes).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kQRows = 128;              // query rows of a CTA tile (two warpgroups)
constexpr int kKeys = 64;                // keys per tile
constexpr int kTile = kKeys * 64;        // one 64-row tile (elements, 8 KB)
constexpr int kQTile = kQRows * 64;      // one 128-row Q tile (elements, 16 KB)
constexpr int kIlvStages = 4;
constexpr int kChunkStages = 8;
constexpr int kThreads = 256;            // two warpgroups
constexpr float kMagic = 12582912.f;     // 1.5 * 2^23
constexpr float kNegBf16 = -0x1.94p+99f;  // bf16(-1e30), bits 0xF14A0000

__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -127.f);
  const float t = __fadd_rd(x, kMagic);  // floor(x) + 1.5 * 2^23, exactly
  const float xf = x - (t - kMagic);
  // floor(x) + 0x4B400000 in the bits of t; shifted by 23 the constant
  // part leaves 32 bits, so the exponent field is floor(x) + 127
  const uint32_t k = static_cast<uint32_t>(min(__float_as_int(t), 0x4B400000 + 127));
  const float sc = __uint_as_float((k << 23) + (127u << 23));
  const float pf =
      fmaf(xf, fmaf(xf, fmaf(xf, fmaf(xf, 0.0135115307f, 0.051989575f), 0.241508857f),
                    0.69297426f),
           1.00000526f);
  return sc * pf;
}

// s (a 64-key score tile in the accumulator layout) becomes p = exp2_poly(s),
// row sums into l; with MASK, keys at or past `valid` of the tile score -1e30.
template <bool MASK>
__device__ __forceinline__ void exp_rows(float (&s)[32], float (&l)[2], int valid, int c2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i];
    if constexpr (MASK) {
      if ((i >> 2) * 8 + c2 + (i & 1) >= valid) x = -1e30f;
    }
    const float p = exp2_poly(x);
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// a and b rounded to bf16 (cvt.rn.bf16x2.f32: round to nearest even), back
// as fp32: a is the low half of the pair, b the high one.
__device__ __forceinline__ void round_pair(float& a, float& b) {
  const uint32_t w = pack_bf16x2(a, b);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

// The row maxima m of a 64-key score tile (accumulator layout) over its
// keys before `valid` (MASK) or all, on the fp32 scores.
template <bool MASK>
__device__ __forceinline__ void max_rows(float (&m)[2], const float (&s)[32], int valid, int c2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (MASK) {
      if ((i >> 2) * 8 + c2 + (i & 1) >= valid) continue;
    }
    m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
  }
}

// sbf16's chain on a 64-key score tile s (accumulator layout), in place:
// x = bf16(s), keys at or past `valid` of the tile (MASK) at bf16(-1e30);
// EXACT x = bf16(x - m), m the bf16 global row max; p = exp2_poly(x), row
// sums into l.
template <bool MASK, bool EXACT>
__device__ __forceinline__ void sbf16_rows(float (&s)[32], float (&l)[2], const float (&m)[2],
                                           int valid, int c2) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1;
    float a = s[i], b = s[i + 1];
    round_pair(a, b);
    if constexpr (MASK) {
      const int col = (i >> 2) * 8 + c2;
      if (col >= valid) a = kNegBf16;
      if (col + 1 >= valid) b = kNegBf16;
    }
    if constexpr (EXACT) {
      a -= m[r];
      b -= m[r];
      round_pair(a, b);
    }
    s[i] = exp2_poly(a);
    s[i + 1] = exp2_poly(b);
    l[r] += s[i];
    l[r] += s[i + 1];
  }
}

// P (accumulator layout) as bf16 A fragments, 16 keys a step.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// A warpgroup's 64 rows of a Q tile (4096 bf16, landed raw by TMA) times c
// in fp32, rounded to bf16, in place, then made visible to wgmma.  The
// 128-byte swizzle moves 16-byte chunks only, so the elementwise pass
// ignores it.
__device__ __forceinline__ void prescale(bf16* rows, float c, int tid) {
  uint4* p = reinterpret_cast<uint4*>(rows);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4 u = p[tid + 128 * i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<bf162*>(&w[r]));
      w[r] = pack_bf16x2(f.x * c, f.y * c);
    }
    p[tid + 128 * i] = u;
  }
  fence_async_smem();
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The warp's 16 rows (row0 + g, + 8) of one head's output, acc / l rounded
// to bf16; rows >= n are not stored.  l is the lane's partial row sums.
// acc is read through asm statements, after the wait that retired its
// last product and without redefining it, so the reads stay after the
// wait and ptxas sees no write to a wgmma register.
__device__ __forceinline__ void store_rows(bf16* o, long long stride, int row0, int n,
                                           const float (&acc)[32], const float (&l_part)[2],
                                           float pad, int lane) {
  const float l0 = quad_sum(l_part[0]) - pad, l1 = quad_sum(l_part[1]) - pad;
  const int r0 = row0 + (lane >> 2), c2 = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("mov.b32 %0, %1;" : "=f"(a[e]) : "f"(acc[4 * t + e]));
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(o + (long long)r0 * stride + t * 8 + c2) =
          pack_bf16x2(a[0] / l0, a[1] / l0);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(o + (long long)(r0 + 8) * stride + t * 8 + c2) =
          pack_bf16x2(a[2] / l1, a[3] / l1);
  }
}

// A warpgroup's release of a ring slot (one thread, after the wait that
// retired the products reading it): true for the second of the two
// warpgroups, which then refills it.  The count only grows, so no reset
// races a later release.
__device__ __forceinline__ bool second_release(int* count) { return atomicAdd(count, 1) & 1; }

__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
}

// acc (+)= P V over one 64-key tile; first = 1 overwrites acc.
__device__ __forceinline__ void issue_pv(float (&acc)[32], const uint32_t (&pa)[4][4],
                                         uint64_t dv, int first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(acc, pa[kk], dv + 128 * kk, kk > 0 || !first);
  wgmma_commit();
}

// ---------------------------------------------------------------- ilv ----
struct IlvSmem {
  bf16 q[2][kQTile];                // both heads' 128 query rows: 32 KB
  bf16 kv[kIlvStages][4][kTile];    // K0, K1, V0, V1 of a key tile: 32 KB a stage
  uint64_t q_full, full[kIlvStages];
  int released[kIlvStages];
};
constexpr int kIlvSmemBytes = sizeof(IlvSmem) + 1024;

template <bool NOMASK>
__global__ void __launch_bounds__(kThreads, 1) ilv_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n, int heads,
    float qscale) {
  extern __shared__ unsigned char smem_raw[];
  IlvSmem& sm = aligned_smem<IlvSmem>(smem_raw);
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;  // rows cw * 64 .. + 64
  const int h0 = 2 * blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kQRows;
  const int n_pad = (n + 127) / 128 * 128, n_tiles = n_pad / kKeys;
  auto load_tile = [&](int j) {  // K0, K1, V0, V1 of key tile j into its stage
    const int s = j % kIlvStages;
    mbar_arrive_expect_tx(&sm.full[s], 4 * kTile * 2);
    tma_load_4d(sm.kv[s][0], &tk, &sm.full[s], 0, h0, j * kKeys, b);
    tma_load_4d(sm.kv[s][1], &tk, &sm.full[s], 0, h0 + 1, j * kKeys, b);
    tma_load_4d(sm.kv[s][2], &tv, &sm.full[s], 0, h0, j * kKeys, b);
    tma_load_4d(sm.kv[s][3], &tv, &sm.full[s], 0, h0 + 1, j * kKeys, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kIlvStages; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.released[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q of both heads and the first stages
    mbar_arrive_expect_tx(&sm.q_full, 2 * kQTile * 2);
    tma_load_4d(sm.q[0], &tq, &sm.q_full, 0, h0, q0, b);
    tma_load_4d(sm.q[1], &tq, &sm.q_full, 0, h0 + 1, q0, b);
    for (int j = 0; j < min(kIlvStages, n_tiles); ++j) load_tile(j);
  }
  // both heads of the pair
  const int warp = tid >> 5, lane = tid & 31, c2 = (lane & 3) * 2;
  mbar_wait(&sm.q_full, 0);
  prescale(sm.q[0] + cw * 64 * 64, qscale, tid);
  prescale(sm.q[1] + cw * 64 * 64, qscale, tid);
  bar_sync(1 + cw, 128);
  const uint64_t dq0 = desc_sw128(sm.q[0] + cw * 64 * 64), dq1 = desc_sw128(sm.q[1] + cw * 64 * 64);

  float s0[32], s1[32], o0[32], o1[32], l0[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f};
  uint32_t p0[4][4], p1[4][4];
  // One key tile; MASK (ilv's tiles past n, peeled into their own loop so
  // that no branch sits between a product and its wait) masks keys >= n.
  auto tile = [&](int j, auto mask_c) {
    constexpr bool MASK = decltype(mask_c)::value;
    const int s = j % kIlvStages, valid = n - j * kKeys;
    mbar_wait(&sm.full[s], (j / kIlvStages) & 1);
    wgmma_fence();
    issue_s(s0, dq0, desc_sw128(sm.kv[s][0]));
    issue_s(s1, dq1, desc_sw128(sm.kv[s][1]));
    // tile j-2's products were retired by tile j-1's first wait: refill its stage
    if (j > 1 && tid == 0 && second_release(&sm.released[(j - 2) % kIlvStages]) &&
        j - 2 + kIlvStages < n_tiles)
      load_tile(j - 2 + kIlvStages);
    wgmma_wait<1>();  // S0 done; so are the previous tile's P V products
    fence_regs(s0);
    exp_rows<MASK>(s0, l0, valid, c2);
    pack_p(p0, s0);
    wgmma_fence();
    issue_pv(o0, p0, desc_sw128(sm.kv[s][2]), j == 0);
    wgmma_wait<1>();  // S1 done, P0 V0 in flight
    fence_regs(s1);
    exp_rows<MASK>(s1, l1, valid, c2);
    pack_p(p1, s1);
    wgmma_fence();
    issue_pv(o1, p1, desc_sw128(sm.kv[s][3]), j == 0);
  };
  const int unmasked = NOMASK ? n_tiles : n / kKeys;
  for (int j = 0; j < unmasked; ++j) tile(j, std::false_type());
  for (int j = unmasked; j < n_tiles; ++j) tile(j, std::true_type());
  wgmma_wait<0>();
  const long long hd = (long long)heads * 64;
  bf16* ob = o + (long long)b * n * hd + (long long)h0 * 64;
  const int row0 = q0 + cw * 64 + warp * 16;
  const float pad = NOMASK ? float(n_pad - n) : 0.f;
  store_rows(ob, hd, row0, n, o0, l0, pad, lane);
  store_rows(ob + 64, hd, row0, n, o1, l1, pad, lane);
}

// -------------------------------------------------------------- sbf16 ----
template <bool FAST, bool CEILING>
__global__ void __launch_bounds__(kThreads, 1) sbf16_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n, int heads,
    float qscale) {
  constexpr bool EXACT = !FAST && !CEILING;
  extern __shared__ unsigned char smem_raw[];
  IlvSmem& sm = aligned_smem<IlvSmem>(smem_raw);
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;  // rows cw * 64 .. + 64
  const int h0 = 2 * blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kQRows;
  const int n_pad = (n + 127) / 128 * 128, n_tiles = n_pad / kKeys;
  // the ring's loads: pass 1's K tiles (exact mode), then pass 2's K and V tiles
  const int pass1 = EXACT ? n_tiles : 0, total = pass1 + n_tiles;
  auto load = [&](int g) {
    const int s = g % kIlvStages, j = g < pass1 ? g : g - pass1;
    mbar_arrive_expect_tx(&sm.full[s], (g < pass1 ? 2 : 4) * kTile * 2);
    tma_load_4d(sm.kv[s][0], &tk, &sm.full[s], 0, h0, j * kKeys, b);
    tma_load_4d(sm.kv[s][1], &tk, &sm.full[s], 0, h0 + 1, j * kKeys, b);
    if (g >= pass1) {
      tma_load_4d(sm.kv[s][2], &tv, &sm.full[s], 0, h0, j * kKeys, b);
      tma_load_4d(sm.kv[s][3], &tv, &sm.full[s], 0, h0 + 1, j * kKeys, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kIlvStages; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.released[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q of both heads and the first stages
    mbar_arrive_expect_tx(&sm.q_full, 2 * kQTile * 2);
    tma_load_4d(sm.q[0], &tq, &sm.q_full, 0, h0, q0, b);
    tma_load_4d(sm.q[1], &tq, &sm.q_full, 0, h0 + 1, q0, b);
    for (int g = 0; g < min(kIlvStages, total); ++g) load(g);
  }
  const int warp = tid >> 5, lane = tid & 31, c2 = (lane & 3) * 2;
  mbar_wait(&sm.q_full, 0);
  prescale(sm.q[0] + cw * 64 * 64, qscale, tid);
  prescale(sm.q[1] + cw * 64 * 64, qscale, tid);
  bar_sync(1 + cw, 128);
  const uint64_t dq0 = desc_sw128(sm.q[0] + cw * 64 * 64), dq1 = desc_sw128(sm.q[1] + cw * 64 * 64);

  float s0[32], s1[32], o0[32], o1[32], l0[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f};
  float m0[2] = {-INFINITY, -INFINITY}, m1[2] = {-INFINITY, -INFINITY};
  uint32_t p0[4][4], p1[4][4];
  const int unmasked = CEILING ? n_tiles : n / kKeys;  // tiles with no key at or past n
  if constexpr (EXACT) {  // pass 1: the row max, both heads
    auto max_tile = [&](int g, auto mask_c) {
      constexpr bool MASK = decltype(mask_c)::value;
      const int s = g % kIlvStages, valid = n - g * kKeys;
      mbar_wait(&sm.full[s], (g / kIlvStages) & 1);
      wgmma_fence();
      issue_s(s0, dq0, desc_sw128(sm.kv[s][0]));
      issue_s(s1, dq1, desc_sw128(sm.kv[s][1]));
      wgmma_wait<1>();
      fence_regs(s0);
      max_rows<MASK>(m0, s0, valid, c2);
      wgmma_wait<0>();
      fence_regs(s1);
      max_rows<MASK>(m1, s1, valid, c2);
      // both products read the stage: it goes back now
      if (tid == 0 && second_release(&sm.released[s]) && g + kIlvStages < total)
        load(g + kIlvStages);
    };
    for (int g = 0; g < unmasked; ++g) max_tile(g, std::false_type());
    for (int g = unmasked; g < n_tiles; ++g) max_tile(g, std::true_type());
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m0[r] = bf16_round(quad_max(m0[r]));
      m1[r] = bf16_round(quad_max(m1[r]));
    }
  }
  // pass 2 (the only one of sbf16:fast and ceiling), in ilv_hopper's order
  auto chain = [&](float (&s)[32], float (&l)[2], const float (&m)[2], int valid, auto mask_c) {
    if constexpr (!CEILING) sbf16_rows<decltype(mask_c)::value, EXACT>(s, l, m, valid, c2);
  };
  auto tile = [&](int j, auto mask_c) {
    const int g = pass1 + j, s = g % kIlvStages, valid = n - j * kKeys;
    mbar_wait(&sm.full[s], (g / kIlvStages) & 1);
    wgmma_fence();
    issue_s(s0, dq0, desc_sw128(sm.kv[s][0]));
    issue_s(s1, dq1, desc_sw128(sm.kv[s][1]));
    // tile j-2's products were retired by tile j-1's first wait: refill its
    // stage (pass 1 gave back its own stages)
    if (j > 1 && tid == 0 && second_release(&sm.released[(g - 2) % kIlvStages]) &&
        g - 2 + kIlvStages < total)
      load(g - 2 + kIlvStages);
    wgmma_wait<1>();  // S0 done; so are the previous tile's P V products
    fence_regs(s0);
    chain(s0, l0, m0, valid, mask_c);
    pack_p(p0, s0);  // ceiling: p = bf16(s)
    wgmma_fence();
    issue_pv(o0, p0, desc_sw128(sm.kv[s][2]), j == 0);
    wgmma_wait<1>();  // S1 done, P0 V0 in flight
    fence_regs(s1);
    chain(s1, l1, m1, valid, mask_c);
    pack_p(p1, s1);
    wgmma_fence();
    issue_pv(o1, p1, desc_sw128(sm.kv[s][3]), j == 0);
  };
  for (int j = 0; j < unmasked; ++j) tile(j, std::false_type());
  for (int j = unmasked; j < n_tiles; ++j) tile(j, std::true_type());
  wgmma_wait<0>();
  const long long hd = (long long)heads * 64;
  bf16* ob = o + (long long)b * n * hd + (long long)h0 * 64;
  const int row0 = q0 + cw * 64 + warp * 16;
  const float pad = CEILING ? -float(n_pad) : 0.f;  // ceiling: l = 0 - pad = n_pad
  store_rows(ob, hd, row0, n, o0, l0, pad, lane);
  store_rows(ob + 64, hd, row0, n, o1, l1, pad, lane);
}

// -------------------------------------------------------------- chunk ----
struct ChunkSmem {
  bf16 q[2][kQTile];                 // Q of two streams: 32 KB
  bf16 kv[kChunkStages][2][kTile];   // K, V of a step: 16 KB a stage
  uint64_t q_full[2], full[kChunkStages];
  int q_released[2], released[kChunkStages];
};
constexpr int kChunkSmemBytes = sizeof(ChunkSmem) + 1024;

__global__ void __launch_bounds__(kThreads, 1) chunk_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n, int heads,
    float qscale, int nc) {
  extern __shared__ unsigned char smem_raw[];
  ChunkSmem& sm = aligned_smem<ChunkSmem>(smem_raw);
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;  // rows cw * 64 .. + 64 of a chunk
  const int h0 = 2 * blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * nc * kQRows;
  const int nct = min(nc, (n - row0 + kQRows - 1) / kQRows);  // chunks with real rows
  const int n_pad = (n + 127) / 128 * 128;
  const int kt = n_pad / kKeys;  // key tiles per stream: even, >= 2
  const int steps = 2 * nct * kt;
  // step i: stream st = i / kt = head * nct + chunk, key tile i % kt
  auto load_q = [&](int st) {  // the stream's 128 query rows into its slot
    const int slot = st & 1;
    mbar_arrive_expect_tx(&sm.q_full[slot], kQTile * 2);
    tma_load_4d(sm.q[slot], &tq, &sm.q_full[slot], 0, h0 + st / nct, row0 + (st % nct) * kQRows,
                b);
  };
  auto load_step = [&](int i) {  // K and V of step i into its stage
    const int s = i % kChunkStages, h = h0 + (i / kt) / nct;
    mbar_arrive_expect_tx(&sm.full[s], 2 * kTile * 2);
    tma_load_4d(sm.kv[s][0], &tk, &sm.full[s], 0, h, (i % kt) * kKeys, b);
    tma_load_4d(sm.kv[s][1], &tv, &sm.full[s], 0, h, (i % kt) * kKeys, b);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.q_full[s], 1);
      sm.q_released[s] = 0;
    }
#pragma unroll
    for (int s = 0; s < kChunkStages; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.released[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the first two streams' Q (there are at least two) and stages
    load_q(0);
    load_q(1);
    for (int i = 0; i < min(kChunkStages, steps); ++i) load_step(i);
  }
  const int warp = tid >> 5, lane = tid & 31;
  const long long hd = (long long)heads * 64;
  const float pad = float(n_pad - n);
  float S[2][32], acc[32], l_cur[2] = {0.f, 0.f}, l_fin[2] = {0.f, 0.f};
  uint32_t P[2][4][4];
  using C0 = std::integral_constant<int, 0>;
  using C1 = std::integral_constant<int, 1>;
  using C2 = std::integral_constant<int, 2>;
  using CN = std::integral_constant<int, -1>;

  // the output of the stream that step j ends
  auto store_stream = [&](int j) {
    const int st = j / kt;
    store_rows(o + (long long)b * n * hd + (long long)(h0 + st / nct) * 64, hd,
               row0 + (st % nct) * kQRows + cw * 64 + warp * 16, n, acc, l_fin, pad, lane);
  };
  // stage 1 of step i: issue S(i) (the stream's Q prescaled at its first step)
  auto issue_step = [&](int i, auto par_c) {
    constexpr int PAR = decltype(par_c)::value;  // i & 1
    const int st = i / kt, slot = st & 1;
    if (i % kt == 0) {
      mbar_wait(&sm.q_full[slot], (st >> 1) & 1);
      prescale(sm.q[slot] + cw * 64 * 64, qscale, tid);
      bar_sync(1 + cw, 128);
    }
    mbar_wait(&sm.full[i % kChunkStages], (i / kChunkStages) & 1);
    wgmma_fence();
    issue_s(S[PAR], desc_sw128(sm.q[slot] + cw * 64 * 64),
            desc_sw128(sm.kv[i % kChunkStages][0]));
    // P V(i-4) was retired in step i-1: refill its stage
    if (i >= 4 && tid == 0 && second_release(&sm.released[(i - 4) % kChunkStages]) &&
        i - 4 + kChunkStages < steps)
      load_step(i - 4 + kChunkStages);
  };
  // stage 2 of step i: the chain of step i - 1.  WS groups may stay in
  // flight once S(i-1) is done (those committed after it: P V(i-3), S(i));
  // WP once P V(i-3) is done (WP < 0: there is none), whose P(i-1) then
  // overwrites, and which may end a stream.
  auto chain_step = [&](int i, auto par_c, auto ws_c, auto wp_c) {
    constexpr int PAR = decltype(par_c)::value, WS = decltype(ws_c)::value,
                  WP = decltype(wp_c)::value;
    wgmma_wait<WS>();
    fence_regs(S[PAR ^ 1]);
    exp_rows<false>(S[PAR ^ 1], l_cur, kKeys, 0);
    if constexpr (WP >= 0) {
      wgmma_wait<WP>();
      if ((i - 3) % kt == kt - 1) store_stream(i - 3);
    }
    pack_p(P[PAR ^ 1], S[PAR ^ 1]);
    if ((i - 1) % kt == kt - 1) {  // the stream's last S is done: its Q slot goes back
      const int st = (i - 1) / kt;
      l_fin[0] = l_cur[0];
      l_fin[1] = l_cur[1];
      l_cur[0] = l_cur[1] = 0.f;
      if (tid == 0 && second_release(&sm.q_released[st & 1]) && st + 2 < 2 * nct) load_q(st + 2);
    }
  };
  // stage 3 of step i: issue P V(i-2), overwriting acc at a stream's first step
  auto pv_step = [&](int i, auto par_c) {
    constexpr int PAR = decltype(par_c)::value;
    const int j = i - 2;
    wgmma_fence();
    issue_pv(acc, P[PAR], desc_sw128(sm.kv[j % kChunkStages][1]), j % kt == 0);
  };

  issue_step(0, C0());
  issue_step(1, C1());
  chain_step(1, C1(), C1(), CN());
  issue_step(2, C0());
  chain_step(2, C0(), C1(), CN());
  pv_step(2, C0());
  int i = 3;  // steps is even: pairs of steps keep the buffer parity compile-time
  for (; i + 1 < steps; i += 2) {
    issue_step(i, C1());
    chain_step(i, C1(), C2(), C1());
    pv_step(i, C1());
    issue_step(i + 1, C0());
    chain_step(i + 1, C0(), C2(), C1());
    pv_step(i + 1, C0());
  }
  issue_step(i, C1());  // i = steps - 1
  chain_step(i, C1(), C2(), C1());
  pv_step(i, C1());
  chain_step(steps, C0(), C1(), C0());
  pv_step(steps, C0());
  pv_step(steps + 1, C1());
  wgmma_wait<0>();
  store_stream(steps - 1);
}

// -------------------------------------------------------------- chain ----
enum ChainMode { GEMMS, EXP, EXACT, SEXP, PEXP, BF16S, BF16X };
constexpr int kChainStages = 6;
constexpr int kChainThreads = 384;  // a producer warpgroup and two consumer warpgroups

struct ChainSmem {
  bf16 q[kQTile];                    // the CTA's 128 query rows: 16 KB
  bf16 kv[kChainStages][2][kTile];   // K and V[:, :64] of a 64-key tile: 16 KB a stage
  uint64_t q_full, full[kChainStages], empty[kChainStages];
};
constexpr int kChainSmemBytes = sizeof(ChainSmem) + 1024;

// kern's chain for MODE on a 64-key score tile (accumulator layout), in
// place: p of each score.  EXACT first moves its running max m to the
// tile's and returns the factor alpha = exp(m_old - m_new) of the rows'
// accumulators; BF16X takes m, the bf16 global row max, from pass 1.  The
// intrinsics are the mma.sync kernel's; bf16 rounding is cvt.rn on pairs.
template <int MODE>
__device__ __forceinline__ void chain_rows(float (&s)[32], float (&m)[2], float (&alpha)[2]) {
  if constexpr (MODE == EXACT) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[4 * t + 2 * r], s[4 * t + 2 * r + 1]));
      mx = quad_max(mx);
      alpha[r] = __expf(m[r] - mx);
      m[r] = mx;
    }
  }
  if constexpr (MODE == BF16S || MODE == BF16X) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) round_pair(s[i], s[i + 1]);
  }
  if constexpr (MODE == BF16X) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float r = m[(i >> 1) & 1];
      s[i] -= r;
      s[i + 1] -= r;
      round_pair(s[i], s[i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = s[i];
    float pe = x;  // GEMMS
    if constexpr (MODE == EXP || MODE == BF16S || MODE == BF16X) {
      pe = exp2f(x);  // BF16S / BF16X: P's bf16 pack is the chain's last rounding
    } else if constexpr (MODE == EXACT) {
      pe = __expf(x - m[(i >> 1) & 1]);
    } else if constexpr (MODE == SEXP) {
      pe = __int_as_float(__float2int_rz(fmaf(x, 8388608.f, 1065353216.f)));
    } else if constexpr (MODE == PEXP) {
      const float xi = floorf(x), xf = x - xi;
      const float sc = __int_as_float(int(unsigned(__float2int_rz(xi) + 127) << 23));
      pe = sc * fmaf(xf, fmaf(xf, fmaf(xf, 0.0779731f, 0.2288332f), 0.6951937f), 1.f);
    }
    s[i] = pe;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kChainThreads, 1) chain_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int nq, int nk) {
  constexpr bool TWO_PASS = MODE == BF16X;
  extern __shared__ unsigned char smem_raw[];
  ChainSmem& sm = aligned_smem<ChainSmem>(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * kQRows;
  const int n_tiles = nk / kKeys;
  const int pass1 = TWO_PASS ? n_tiles : 0, total = pass1 + n_tiles;  // the ring's loads
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kChainStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);  // both consumer warpgroups
    }
    fence_mbar_init();
  }
  __syncthreads();

  // a consumer warpgroup is done with ring load g
  auto release = [&](int g) {
    if (tid == 0) mbar_arrive(&sm.empty[g % kChainStages]);
  };
  if (wg == 0) {  // producer: Q once, then pass 1's K tiles and pass 2's K and V tiles
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kQTile * 2);
      tma_load_4d(sm.q, &tq, &sm.q_full, 0, 0, q0, bh);
      for (int g = 0; g < total; ++g) {
        const int s = g % kChainStages, key0 = (g < pass1 ? g : g - pass1) * kKeys;
        if (g >= kChainStages) mbar_wait(&sm.empty[s], (g / kChainStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], (g < pass1 ? 1 : 2) * kTile * 2);
        tma_load_4d(sm.kv[s][0], &tk, &sm.full[s], 0, 0, key0, bh);
        if (g >= pass1) tma_load_4d(sm.kv[s][1], &tv, &sm.full[s], 0, 0, key0, bh);
      }
    }
  } else {  // consumers: query rows cw * 64 .. + 64 of the CTA's 128
    setmaxnreg_inc<240>();
    const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
    mbar_wait(&sm.q_full, 0);
    const uint64_t dq = desc_sw128(sm.q + cw * 64 * 64);
    float m[2] = {-INFINITY, -INFINITY}, alpha[2] = {1.f, 1.f};
    float S[2][32], acc[32];
    uint32_t P[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if constexpr (TWO_PASS) {  // pass 1: the global row max of the scores, rounded once
      for (int g = 0; g < pass1; ++g) {
        const int s = g % kChainStages;
        mbar_wait(&sm.full[s], (g / kChainStages) & 1);
        wgmma_fence();
        issue_s(S[0], dq, desc_sw128(sm.kv[s][0]));
        wgmma_wait<0>();
        fence_regs(S[0]);
        release(g);
        max_rows<false>(m, S[0], 0, 0);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = bf16_round(quad_max(m[r]));
    }
    // pass 2: S(j + 1) is issued before the chain of tile j, and P V(j)
    // after it; the stage of tile j - 1 goes back once P V(j - 1) is done
    auto issue_tile = [&](int j, float (&s)[32]) {
      const int g = pass1 + j, st = g % kChainStages;
      mbar_wait(&sm.full[st], (g / kChainStages) & 1);
      wgmma_fence();
      issue_s(s, dq, desc_sw128(sm.kv[st][0]));
    };
    // tile j, its scores in S[PAR]; FIRST: j = 0; MORE: a tile j + 1
    auto step = [&](int j, auto par_c, auto first_c, auto more_c) {
      constexpr int PAR = decltype(par_c)::value;
      constexpr bool FIRST = decltype(first_c)::value, MORE = decltype(more_c)::value;
      if constexpr (MORE) issue_tile(j + 1, S[PAR ^ 1]);
      // in flight, oldest first: S(j), P V(j - 1) unless FIRST, S(j + 1) if MORE
      wgmma_wait<(FIRST ? 0 : 1) + (MORE ? 1 : 0)>();
      fence_regs(S[PAR]);
      chain_rows<MODE>(S[PAR], m, alpha);
      if constexpr (!FIRST) {
        wgmma_wait<MORE ? 1 : 0>();  // P V(j - 1) is done with acc, P and its stage
        fence_regs(acc);
        release(pass1 + j - 1);
      }
      if constexpr (MODE == EXACT) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      pack_p(P, S[PAR]);
      wgmma_fence();
      issue_pv(acc, P, desc_sw128(sm.kv[(pass1 + j) % kChainStages][1]), 0);
    };
    using C0 = std::integral_constant<int, 0>;
    using C1 = std::integral_constant<int, 1>;
    using T = std::true_type;
    using F = std::false_type;
    issue_tile(0, S[0]);
    if (n_tiles == 1) {
      step(0, C0(), T(), F());
    } else {
      step(0, C0(), T(), T());
      int j = 1;
      for (; j + 2 < n_tiles; j += 2) {
        step(j, C1(), F(), T());
        step(j + 1, C0(), F(), T());
      }
      if (j + 2 == n_tiles) {
        step(j, C1(), F(), T());
        step(j + 1, C0(), F(), F());
      } else {
        step(j, C1(), F(), F());
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(total - 1);
    // the unnormalised (P V)[:, :64]; rows >= nq are not stored
    const int r0 = q0 + cw * 64 + warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
    bf16* ob = o + (long long)bh * nq * 64;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * 64 + t * 8 + c2) =
            pack_bf16x2(acc[4 * t], acc[4 * t + 1]);
      if (r0 + 8 < nq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * 64 + t * 8 + c2) =
            pack_bf16x2(acc[4 * t + 2], acc[4 * t + 3]);
    }
  }
}

// The shared-memory size and the tensor maps of a launch (the 4-D maps
// (64, H, N, B) of the contiguous (B, n, heads * 64) operands: Q boxes of
// 128 rows, K and V boxes of 64); a CUDA error code, 0 on success.
template <class K>
int prepare(K kernel, int smem, const void* q, const void* k, const void* v, int batch, int n,
            int heads, CUtensorMap (&maps)[3]) {
  if (n < 1 || heads < 2 || heads % 2 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  // a runtime call before the maps: it makes the context current (make_map)
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long sn = (long long)heads * 64, sb = sn * n;
  if (!make_map(&maps[0], q, batch, n, heads, sb, sn, 64, kQRows) ||
      !make_map(&maps[1], k, batch, n, heads, sb, sn, 64, kKeys) ||
      !make_map(&maps[2], v, batch, n, heads, sb, sn, 64, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <bool NOMASK>
int launch_ilv(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
               float qscale, cudaStream_t st) {
  CUtensorMap maps[3];
  const int err = prepare(ilv_hopper<NOMASK>, kIlvSmemBytes, q, k, v, batch, n, heads, maps);
  if (err) return err;
  const dim3 grid((n + kQRows - 1) / kQRows, heads / 2, batch);
  ilv_hopper<NOMASK><<<grid, kThreads, kIlvSmemBytes, st>>>(maps[0], maps[1], maps[2],
                                                       static_cast<bf16*>(o), n, heads, qscale);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAST, bool CEILING>
int launch_sbf16(const void* q, const void* k, const void* v, void* o, int batch, int n,
                 int heads, float qscale, cudaStream_t st) {
  CUtensorMap maps[3];
  const int err = prepare(sbf16_hopper<FAST, CEILING>, kIlvSmemBytes, q, k, v, batch, n, heads,
                          maps);
  if (err) return err;
  const dim3 grid((n + kQRows - 1) / kQRows, heads / 2, batch);
  sbf16_hopper<FAST, CEILING><<<grid, kThreads, kIlvSmemBytes, st>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), n, heads, qscale);
  return static_cast<int>(cudaGetLastError());
}

// q (bh, nq, 64), k (bh, nk, 64) contiguous, v (bh, nk, dv) contiguous with
// dv >= 64 a multiple of 8, 16-byte aligned bases; o (bh, nq, 64).  The
// maps are 4-D (64, 1, rows, bh) views; V's reads its first 64 columns
// with the row stride dv.
template <int MODE>
int launch_chain(const void* q, const void* k, const void* v, void* o, int bh, int nq, int nk,
                 int dv, cudaStream_t st) {
  const cudaError_t attr = cudaFuncSetAttribute(chain_hopper<MODE>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                kChainSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, nq, 1, (long long)nq * 64, 64, 64, kQRows) ||
      !make_map(&tk, k, bh, nk, 1, (long long)nk * 64, 64, 64, kKeys) ||
      !make_map(&tv, v, bh, nk, 1, (long long)nk * dv, dv, 64, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kQRows - 1) / kQRows, bh);
  chain_hopper<MODE><<<grid, kChainThreads, kChainSmemBytes, st>>>(tq, tk, tv,
                                                                   static_cast<bf16*>(o), nq, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o contiguous (B, n, heads * 64) bf16 with 16-byte aligned bases,
// heads even; qscale = scale * log2(e).  ilv: flag nomask; chunk: nc >= 1;
// sbf16: flags fast, ceiling.
extern "C" int vda_ilv(const void* q, const void* k, const void* v, void* o, int batch, int n,
                       int heads, float qscale, int nomask, int, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nomask ? launch_ilv<true>(q, k, v, o, batch, n, heads, qscale, st)
                : launch_ilv<false>(q, k, v, o, batch, n, heads, qscale, st);
}

extern "C" int vda_chunk(const void* q, const void* k, const void* v, void* o, int batch, int n,
                         int heads, float qscale, int nc, int, void* stream) {
  if (nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const int err = prepare(chunk_hopper, kChunkSmemBytes, q, k, v, batch, n, heads, maps);
  if (err) return err;
  const dim3 grid(((n + kQRows - 1) / kQRows + nc - 1) / nc, heads / 2, batch);
  chunk_hopper<<<grid, kThreads, kChunkSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), n, heads, qscale, nc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vda_sbf16(const void* q, const void* k, const void* v, void* o, int batch, int n,
                         int heads, float qscale, int fast, int ceiling, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ceiling) return launch_sbf16<false, true>(q, k, v, o, batch, n, heads, qscale, st);
  return fast ? launch_sbf16<true, false>(q, k, v, o, batch, n, heads, qscale, st)
              : launch_sbf16<false, false>(q, k, v, o, batch, n, heads, qscale, st);
}

// Chain probe: q (bh, nq, 64), k (bh, nk, 64), v (bh, nk, dv) bf16 (see
// launch_chain), nk a multiple of 64; o (bh, nq, 64).  mode indexes
// (gemms, exp, exact, sexp, pexp, bf16s, bf16x).
extern "C" int vda_chain(const void* q, const void* k, const void* v, void* o, int bh, int nq,
                         int nk, int dv, int mode, void* stream) {
  if (bh < 1 || nq < 1 || nk < kKeys || nk % kKeys || dv < 64 || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case GEMMS: return launch_chain<GEMMS>(q, k, v, o, bh, nq, nk, dv, st);
    case EXP: return launch_chain<EXP>(q, k, v, o, bh, nq, nk, dv, st);
    case EXACT: return launch_chain<EXACT>(q, k, v, o, bh, nq, nk, dv, st);
    case SEXP: return launch_chain<SEXP>(q, k, v, o, bh, nq, nk, dv, st);
    case PEXP: return launch_chain<PEXP>(q, k, v, o, bh, nq, nk, dv, st);
    case BF16S: return launch_chain<BF16S>(q, k, v, o, bh, nq, nk, dv, st);
    case BF16X: return launch_chain<BF16X>(q, k, v, o, bh, nq, nk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
