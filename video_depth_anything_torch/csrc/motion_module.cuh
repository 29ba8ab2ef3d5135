// Kernel C for Hopper (sm_90a): one whole motion module (TemporalModule)
// per block of locations.  Included by motion_module.cu (the launch) and
// motion_module_split.cuh (the split by stage, one source a width), which
// build in parallel.
//
// Replaces video_depth_anything_tpu/ops/pallas_motion.py:_motion_kernel
// (via fused_motion_module).  Per CTA: one batch element and L = R / TP
// consecutive spatial locations, R = 64 * NRB rows of C channels, location
// major (row r = l * TP + t), so that every 64-row block holds whole
// locations.  TP in {8, 16, 32} is the frame count T (8 <= T <= 32) padded
// up: a location's rows t >= T are zero on load, their keys masked out of
// the frame attention, no APE row added to them, and never stored (the
// GroupNorm statistics are folded outside over the true T).  The CTA
// computes
//   GroupNorm apply (statistics folded outside, as _gn_fold does) -> proj_in
//   -> 2 x [LayerNorm, +APE, q/k/v, attention over the T frames per
//           (location, head), out proj, residual]
//   -> LayerNorm -> GEGLU feed-forward -> residual -> proj_out -> + x
// with every activation in shared memory: only x (read twice: at the start
// and for the outer residual), the weights and the output touch device
// memory.  Values are rounded to bf16 where the TPU kernel rounds them (h,
// y, q, k, v, p, attention out, the FF activation, y after each residual),
// at the same points as the PR-1 design this replaces.
//
// Bound on the H100: tensor-core FLOPs, 44 * C^2 + 8 * T * C per token
// (vits m3 at 518^2, C = 64: 32 GFLOP, 0.032 ms at 989 TFLOP/s) over bytes:
// x and the output (45 MB at vits m3 518^2, 180 MB at vitl m3 518^2) and
// the 22 * C^2 bf16 weights once.  What the PR-1 design lost to was weight
// traffic and serialisation: every 32x32 output unit re-read its weight
// columns from L2 with __ldg, tokens * 1.375 * C^2 bytes per call (0.99 GB
// at vits m3 518^2, 15.8 GB at vitl m3 518^2 and at vitb m0 518x924), and
// each of the 22 GEMMs exposed its first load's latency.
//
// Design:
// - Weights through shared memory, in a ring.  The host lays the 22 C^2
//   weights out once (ops/motion_module.weight_blocks, cached by
//   TemporalModule) as the sequence of 64 x 64 blocks (N rows x K, 8 KB)
//   in the exact order the CTA consumes them, each block already in the
//   128-byte swizzle of a TMA box (row n's 16-byte chunk j at j ^ (n % 8)).
//   One producer warp streams block after block with cp.async.bulk into a
//   ring of NSTAGE stages on full and empty mbarriers, so the next GEMM's
//   first blocks arrive while the current one computes.  Every row of the
//   CTA shares one copy of each block: L2 weight bytes per call fall from
//   tokens * 1.375 * C^2 to tokens * 44 * C^2 / R (R = 128 at C = 64 and
//   128: 0.99 -> 0.25 GB at vits m3 518^2, 3.95 -> 0.99 GB at vitb m3
//   518^2; R = 64 at C >= 192: 15.8 -> 7.9 GB at vitl m3 518^2 and at vitb
//   m0 518x924).  Step 0 showed that this traffic was not what the PR-1
//   kernel lost to (weights read from shared memory saved 0-7 %).
// - Products on wgmma m64n64k16, A (activations) and B (a ring block) both
//   K-major in shared memory with the 128-byte swizzle (hopper.cuh).  Each
//   activation buffer is C / 64 panels of R rows x 64 channels, swizzled as
//   a TMA box would be (swz below); epilogues, LayerNorm and attention
//   write that layout.  A 64-row block (64 / TP whole locations) belongs to
//   NSPLIT consumer warpgroups (one at C = 64 and 128, three at C = 192
//   and 384, two at C = 256) that take its 64-wide n blocks round robin,
//   so no warpgroup holds more than 64 accumulator floats per thread (more
//   spilled).
// - Four R x C buffers: y (the residual stream), h (GroupNorm / LayerNorm
//   out, then v: each warpgroup waits until the q/k/v products of its row
//   block have read h), q (then the attention out, each thread writing the
//   slots of the row and head it alone read; then the FF activation) and
//   k.  The feed-forward runs in steps of 64 * NSPLIT hidden columns (one
//   64-column chunk per warpgroup: its h product, then its gate product);
//   its second product accumulates in registers over the steps, so no fp32
//   buffer exists, and at most 32 more accumulator floats live beside it.
//   Shared memory (4 * R * C * 2 + NSTAGE * 8 KB; the ring as deep as the
//   rest leaves room for): C = 64: R = 128, 5 stages, 104 KB, two CTAs per
//   SM; C = 128: R = 128, 10 stages, 208 KB; C = 192: R = 64, 12 stages,
//   192 KB; C = 256: R = 64, 10 stages, 208 KB; C = 384: R = 64, 3 stages,
//   216 KB (one block per warpgroup in flight: its blocks' L2 latency shows).
// - Frame attention on the tensor cores (frame_attention): the PR-1
//   kernel's CUDA-core loop (lane t owning query frame t) took 0.123 ms of
//   0.636 per attention block at vits m3 518^2, though its 8 * T * C FLOPs
//   per token are under 10 % of the GEMMs'.
// - Row blocks never wait for each other: named barriers sync the
//   warpgroups of one row block; only the ring ties the consumers together.
// The TPU's block-diagonal weights, gunit and lane packing are not carried
// over.
//
// STOP < 7 (the split): the CTA returns after stage STOP (0 GroupNorm
// apply, 1 proj_in, 2 block 1's LayerNorm and q/k/v, 3 its attention, 4
// its out projection, 5 block 2, 6 the feed-forward), writing its current
// activation rows to out; the producer streams only the blocks used so
// far.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mm {

constexpr int HEADS = 8;
constexpr int BLK = 64 * 64;  // bf16 per weight block (64 N rows x 64 K)
constexpr int BLK_BYTES = BLK * 2;

// rows per CTA (64 * NRB), warpgroups per 64-row block, ring stages, CTAs
// per SM (the registers' launch bound)
template <int C>
struct Plan;
template <>
struct Plan<64> {
  static constexpr int NRB = 2, NSPLIT = 1, NSTAGE = 5, MINB = 2;
};
template <>
struct Plan<128> {
  static constexpr int NRB = 2, NSPLIT = 1, NSTAGE = 10, MINB = 1;
};
template <>
struct Plan<192> {
  static constexpr int NRB = 1, NSPLIT = 3, NSTAGE = 12, MINB = 1;
};
template <>
struct Plan<256> {
  static constexpr int NRB = 1, NSPLIT = 2, NSTAGE = 10, MINB = 1;
};
template <>
struct Plan<384> {
  static constexpr int NRB = 1, NSPLIT = 3, NSTAGE = 3, MINB = 1;
};

template <int C>
struct Shape {
  static constexpr int NRB = Plan<C>::NRB, NSPLIT = Plan<C>::NSPLIT, NSTAGE = Plan<C>::NSTAGE;
  static constexpr int MINB = Plan<C>::MINB;
  static constexpr int R = 64 * NRB;
  static constexpr int NCONS = NRB * NSPLIT * 128;  // consumer threads
  static constexpr int NTHREADS = NCONS + 32;       // + the producer warp
  static constexpr int KP = C / 64;                 // 64-wide k panels of a C-wide input
  static constexpr int NS = C / 64;                 // 64-wide n blocks of a C-wide output
  static constexpr int NSW = NS / NSPLIT;           // of them per warpgroup
  static constexpr int G = KP * NS;                 // blocks of one C x C weight
  static constexpr int FS = 4 * C / (64 * NSPLIT);  // feed-forward steps
  static constexpr int FF_BLOCKS = 2 * KP * NSPLIT + NSPLIT * NS;  // h, gate, w2
  // weight blocks streamed up to and including stage `stop`
  __host__ __device__ static constexpr int blocks(int stop) {
    return stop <= 0 ? 0 : stop == 1 ? G : stop <= 3 ? 4 * G : stop == 4 ? 5 * G
         : stop == 5 ? 9 * G : stop == 6 ? 9 * G + FS * FF_BLOCKS : 10 * G + FS * FF_BLOCKS;
  }
  static constexpr int SMEM = 4 * R * C * 2 + NSTAGE * BLK_BYTES + 2 * NSTAGE * 8 + 1024;
  static_assert(NS % NSPLIT == 0 && NSW <= 2, "at most 64 accumulator floats per thread");
  static_assert(NSTAGE % NSPLIT == 0 && NSTAGE >= 2, "see gemm: the ring's waits");
  static_assert(SMEM <= 232448, "shared memory over the opt-in limit");
};

struct Params {
  const bf16* x;
  const float* gna;
  const float* gnb;
  const bf16* pe;
  const bf16* w;  // weight_blocks: every GEMM's blocks in consumption order
  const float* b_in;
  const float* ln_s;
  const float* ln_b;
  const float* bo;
  const float* b1;
  const float* b2;
  const float* b_out;
  bf16* out;
  int B, T, S;
  int TP;  // T padded up to 8, 16 or 32: the rows a location takes
  float scale, ln_eps;
};

// the padded frame count of T (0 outside 8..32)
__host__ __device__ constexpr int padded_frames(int T) {
  return T < 8 || T > 32 ? 0 : T <= 8 ? 8 : T <= 16 ? 16 : 32;
}

// element offset of (row, col) in a buffer of C / 64 panels of R x 64,
// each 8-row group's 16-byte chunks XOR-swizzled by row % 8
template <int R>
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * (R * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// bf16(GELU(g)), tanh form, for a bf16-valued g: tanh(u) = 1 - 2 / (1 +
// e^(2u)) with u clamped to +-15 (tanh is +-1 in fp32 there), in a few
// branch-free instructions where tanhf takes many more.  In fp32 it lies
// within 1.8e-7 of tanh over [-15, 15], far inside the bf16 rounding that
// follows (the hardware exp and divide add a few ulps).
__device__ __forceinline__ float gelu_bf16(float g) {
  const float u = fminf(fmaxf(0.7978845608028654f * (g + 0.044715f * g * g * g), -15.f), 15.f);
  const float t = 1.f - __fdividef(2.f, 1.f + __expf(2.f * u));
  return bf16_round(0.5f * g * (1.f + t));
}

template <int NSW>
__device__ __forceinline__ void fence_acc(float (&d)[NSW][32]) {
#pragma unroll
  for (int u = 0; u < NSW; ++u) fence_regs(d[u]);
}

// The weight ring as one consumer warpgroup sees it: block j sits in stage
// j % NSTAGE, full for the (j / NSTAGE)-th time.
template <int NSTAGE>
struct Ring {
  const bf16* buf;
  uint64_t* full;
  uint64_t* empty;
  int j;  // next block of the sequence
};

// acc[u] (+)= A[64 rows x 64*KP] . W^T over the ring's next KP * NS blocks
// (k panel major, 64-wide n blocks inner); this warpgroup takes n blocks
// cs + u * SPLIT (u < NSW), round robin with the row block's other
// warpgroups, and skips the rest.  A: the warpgroup's 64 rows of panel 0
// of an R-row buffer.  `accumulate` = 0 starts from zero.
//
// Block j fills stage j % NSTAGE for the (j / NSTAGE)-th time and the
// owner waits for that fill's parity.  The wait is sound only if the
// stage's previous fill has completed: bulk copies complete out of order,
// and an earlier fill still in flight would show the awaited parity.  With
// NSTAGE a multiple of SPLIT the previous fill is this warpgroup's own
// block, which it waited for itself.  A warpgroup's blocks of one panel
// span (NSW - 1) * SPLIT + 1 stages: where that exceeds the ring, each
// block is released right after its products; where two panels' span fits,
// panel kp + 1's products are issued before panel kp's are waited for.
template <int R, int KP, int NS, int NSW, int SPLIT, int NSTAGE>
__device__ __forceinline__ void gemm(float (&acc)[NSW][32], const bf16* A, int cs,
                                     Ring<NSTAGE>& ring, int accumulate) {
  static_assert(NS == NSW * SPLIT, "every n block has one owner");
  static_assert(NSTAGE % SPLIT == 0, "a stage's previous fill must be the owner's own block");
  constexpr int kSpan = (NSW - 1) * SPLIT + 1;
  constexpr bool kSerial = kSpan > NSTAGE;
  constexpr bool kPipe = !kSerial && NSTAGE >= NS + kSpan;
  const bool leader = (threadIdx.x & 127) == 0;
  auto release = [&](int j) {
    if (leader) mbar_arrive(&ring.empty[j % NSTAGE]);
  };
  auto release_panel = [&](int kp) {
#pragma unroll
    for (int u = 0; u < NSW; ++u) release(ring.j + kp * NS + cs + u * SPLIT);
  };
  // unrolled: a rolled k-panel loop leaves the accumulators loop-carried,
  // which ptxas moved through local memory (thousands of spilled bytes)
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
    const int j0 = ring.j + kp * NS + cs;
    const uint64_t da = desc_sw128(A + kp * R * 64);
#pragma unroll
    for (int u = 0; u < NSW; ++u) {
      const int j = j0 + u * SPLIT;
      if (u == 0 || kSerial) wgmma_fence();
      mbar_wait(&ring.full[j % NSTAGE], (j / NSTAGE) & 1);
      const uint64_t db = desc_sw128(ring.buf + (j % NSTAGE) * BLK);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64(acc[u], da + 2 * ks, db + 2 * ks, (accumulate | kp | ks) ? 1 : 0);
      if constexpr (kSerial) {
        wgmma_commit();
        wgmma_wait<0>();
        release(j);
      }
    }
    if constexpr (!kSerial) {
      wgmma_commit();
      if constexpr (kPipe) {
        if (kp > 0) {
          wgmma_wait<1>();  // panel kp - 1's products are done with its blocks
          release_panel(kp - 1);
        }
      } else {
        wgmma_wait<0>();
        release_panel(kp);
      }
    }
  }
  if constexpr (kPipe) {
    wgmma_wait<0>();
    release_panel(KP - 1);
  }
  fence_acc(acc);
  ring.j += KP * NS;
}

// epi(row, col, v0, v1) over the accumulator pairs of this warpgroup's 64
// rows (row0..) and n blocks cs + u * SPLIT: the m64n64 C layout of
// hopper.cuh
template <int SPLIT, int NSW, typename Epi>
__device__ __forceinline__ void for_acc(const float (&acc)[NSW][32], int row0, int cs, Epi epi) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int u = 0; u < NSW; ++u)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(row0 + warp * 16 + (lane >> 2) + 8 * h, (cs + u * SPLIT) * 64 + t * 8 + (lane & 3) * 2,
            acc[u][4 * t + 2 * h], acc[u][4 * t + 2 * h + 1]);
}

// dst = bf16(LN(src)) (+ APE row of the frame where t < T, rounded again)
// on the row block's 64 rows, warp per row (`wrb` = warp within the row
// block)
template <int C, int R>
__device__ __forceinline__ void layer_norm(const bf16* src, bf16* dst, int row0, int wrb, int nwarps, int T,
                           int TP, const float* sc, const float* bi, const bf16* pe, float eps) {
  constexpr int NP = C / 64;
  const int lane = threadIdx.x & 31;
  for (int r = row0 + wrb; r < row0 + 64; r += nwarps) {
    float2 v[NP];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      v[j] = ld2(src + swz<R>(r, j * 64 + lane * 2));
      s1 += v[j].x + v[j].y;
      s2 += v[j].x * v[j].x + v[j].y * v[j].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    constexpr float kInvC = 1.f / C;
    const float mean = s1 * kInvC;
    const float inv = rsqrtf(fmaxf(s2 * kInvC - mean * mean, 0.f) + eps);
    const int t = r % TP;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int c = j * 64 + lane * 2;
      float a = bf16_round((v[j].x - mean) * (inv * sc[c]) + bi[c]);
      float b = bf16_round((v[j].y - mean) * (inv * sc[c + 1]) + bi[c + 1]);
      if (pe != nullptr && t < T) {
        const float2 p = ld2(pe + t * C + c);
        a += p.x;
        b += p.y;
      }
      st2(dst + swz<R>(r, c), a, b);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(smem)));
}

// Frame attention of the row block's locations on the tensor cores: one
// warp per (location, head), S = Q K^T (T x T over DH) and O = P V (T x DH
// over T) on mma.sync m16n8k16 with fp32 accumulate, the max-subtracted
// softmax on the S fragments in registers (a row's values sit in one lane
// quad), P rounded to bf16 once normalised, as the PR-1 kernel rounds it.
// DH = 8 or 24 fills the last k16 step's upper half, TP = 8 the P V step's,
// with zeros; fragment rows past TP are clamped to row TP - 1 and never
// stored.  Key frames t >= T (the padding of a location's TP rows) score
// -inf before the max, so they get p = 0.  The out overwrites the query's
// own slots (the warp has read them all).
template <int C, int R, int TP>
__device__ __forceinline__ void frame_attention(bf16* sQ, const bf16* sK, const bf16* sV, int row0, int wrb,
                                int nwarps, float scale, int T) {
  constexpr int DH = C / HEADS;
  constexpr int KS = (DH + 15) / 16;  // k16 steps of S
  constexpr int DN = DH / 8;          // n8 tiles of O
  constexpr int MT = (TP + 15) / 16;  // m16 tiles (query frames), = k16 steps of P V
  constexpr int NT = TP / 8;          // n8 tiles of S (key frames)
  constexpr int LOCS = 64 / TP;
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int r16 = lane & 15, r8 = lane & 7;
  for (int task = wrb; task < LOCS * HEADS; task += nwarps) {
    const int base = row0 + (task / HEADS) * TP, col = (task % HEADS) * DH;
    auto row = [&](int r) { return base + (r < TP ? r : TP - 1); };
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      constexpr bool kHalfLast = DH % 16 != 0;
      const bool half = kHalfLast && ks == KS - 1;
      const int k_hi = col + ks * 16 + (half ? 0 : 8);  // the upper 8 columns (valid chunk)
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                    sQ + swz<R>(row(mt * 16 + r16), (lane >> 4) ? k_hi : col + ks * 16));
        if (half) a[mt][2] = a[mt][3] = 0u;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, sK + swz<R>(row(nt * 8 + r8), (lane & 8) ? k_hi : col + ks * 16));
        if (half) b1 = 0u;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(s[mt][nt], a[mt], b0, b1);
      }
    }
    // softmax over the key frames: row g in e = 0, 1, row g + 8 in e = 2, 3
    uint32_t pa[MT][MT][4];  // P as A fragments: [m tile][k16 step]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_past_t = nt * 8 + 2 * c4 + (e & 1) >= T;
          s[mt][nt][e] = key_past_t ? -INFINITY : s[mt][nt][e] * scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = __expf(s[mt][nt][e] - mx[e >> 1]);
          sum[e >> 1] += s[mt][nt][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        sum[h] = __fdividef(1.f, sum[h]);
      }
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        const int n0 = 2 * kk, n1 = 2 * kk + 1;
        pa[mt][kk][0] = pack_bf16x2(s[mt][n0][0] * sum[0], s[mt][n0][1] * sum[0]);
        pa[mt][kk][1] = pack_bf16x2(s[mt][n0][2] * sum[1], s[mt][n0][3] * sum[1]);
        if (n1 < NT) {
          pa[mt][kk][2] = pack_bf16x2(s[mt][n1][0] * sum[0], s[mt][n1][1] * sum[0]);
          pa[mt][kk][3] = pack_bf16x2(s[mt][n1][2] * sum[1], s[mt][n1][3] * sum[1]);
        } else {
          pa[mt][kk][2] = pa[mt][kk][3] = 0u;
        }
      }
    }
    float o[MT][DN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk)
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;  // V^T fragments: key frames kk*16 .. +15, columns dn*8 .. +7
        ldmatrix_x2_trans(b0, b1, sV + swz<R>(row(kk * 16 + (lane & 8) + r8), col + dn * 8));
        if (2 * kk + 1 >= NT) b1 = 0u;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(o[mt][dn], pa[mt][kk], b0, b1);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r < TP) {
#pragma unroll
          for (int dn = 0; dn < DN; ++dn)
            st2(sQ + swz<R>(base + r, col + dn * 8 + 2 * c4), o[mt][dn][2 * h], o[mt][dn][2 * h + 1]);
        }
      }
  }
}

// the row block's rows of an activation buffer to out (the split's stop)
template <int C, int R>
__device__ __forceinline__ void store_rows(const Params& p, const bf16* src, int row0, int rtid,
                                           int nthr, int b, int s0) {
  for (int i = rtid; i < 64 * (C / 8); i += nthr) {
    const int r = row0 + i / (C / 8), cc = (i % (C / 8)) * 8;
    const int t = r % p.TP, s = s0 + r / p.TP;
    if (s < p.S && t < p.T)
      *reinterpret_cast<uint4*>(p.out + ((long long)(b * p.T + t) * p.S + s) * C + cc) =
          *reinterpret_cast<const uint4*>(src + swz<R>(r, cc));
  }
}

template <int C, int STOP>
__global__ void __launch_bounds__(Shape<C>::NTHREADS, Shape<C>::MINB) motion_hopper(const Params p) {
  using SH = Shape<C>;
  constexpr int R = SH::R, NSPLIT = SH::NSPLIT, NSTAGE = SH::NSTAGE, NSW = SH::NSW;
  constexpr int KP = SH::KP, NS = SH::NS, FF = 4 * C;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  bf16* sY = reinterpret_cast<bf16*>(smem_raw + pad);
  bf16* sH = sY + R * C;  // GroupNorm / LayerNorm out, then v
  bf16* sQ = sH + R * C;  // q, then the attention out, then the FF activation
  bf16* sK = sQ + R * C;
  bf16* ring_buf = sK + R * C;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_buf + NSTAGE * BLK);
  uint64_t* empty = full + NSTAGE;

  const int T = p.T, TP = p.TP, S = p.S;
  const int b = blockIdx.y, s0 = blockIdx.x * (R / TP);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SH::NRB);  // one release per row block: its owner of the block
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= SH::NCONS) {  // the producer warp: one thread streams the blocks
    if (threadIdx.x == SH::NCONS) {
      constexpr int NB = SH::blocks(STOP);
      for (int j = 0; j < NB; ++j) {
        const int s = j % NSTAGE;
        if (j >= NSTAGE) mbar_wait(&empty[s], (j / NSTAGE - 1) & 1);
        mbar_arrive_expect_tx(&full[s], BLK_BYTES);
        bulk_load(ring_buf + s * BLK, p.w + (long long)j * BLK, BLK_BYTES, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, rb = wg / NSPLIT, cs = wg % NSPLIT;
  const int rtid = threadIdx.x - rb * NSPLIT * 128;  // thread within the row block
  const int wrb = rtid >> 5, nwarps = NSPLIT * 4;
  const int row0 = rb * 64;
  const int bar = 1 + rb;
  auto sync_rows = [&] { bar_sync(bar, NSPLIT * 128); };
  Ring<NSTAGE> ring{ring_buf, full, empty, 0};
  const bf16* aH = sH + row0 * 64;  // this warpgroup's A rows of each buffer
  const bf16* aQ = sQ + row0 * 64;
  const bf16* aY = sY + row0 * 64;
  // Each product's accumulators are declared where it runs: the first
  // wgmma of a product reads them (scale_d = 0 ignores the values), which
  // would otherwise keep a dead accumulator alive across the next stages.

  // GroupNorm apply with the folded per-(b, t, c) scale and shift; a
  // padded frame's rows are zero
  for (int i = rtid; i < 64 * (C / 8); i += NSPLIT * 128) {
    const int r = row0 + i / (C / 8), cc = (i % (C / 8)) * 8;
    const int t = r % TP, s = s0 + r / TP;
    if (t >= T) {
      *reinterpret_cast<uint4*>(sH + swz<R>(r, cc)) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) xv = *reinterpret_cast<const uint4*>(p.x + ((long long)(b * T + t) * S + s) * C + cc);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const float4* a4 = reinterpret_cast<const float4*>(p.gna + (long long)(b * T + t) * C + cc);
    const float4* b4 = reinterpret_cast<const float4*>(p.gnb + (long long)(b * T + t) * C + cc);
    const float4 av[2] = {a4[0], a4[1]}, bv[2] = {b4[0], b4[1]};
    const float* a = reinterpret_cast<const float*>(av);
    const float* bb = reinterpret_cast<const float*>(bv);
    uint4 hv;
    uint32_t* h2 = reinterpret_cast<uint32_t*>(&hv);
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      h2[j / 2] = pack_bf16x2(__bfloat162float(xe[j]) * a[j] + bb[j],
                              __bfloat162float(xe[j + 1]) * a[j + 1] + bb[j + 1]);
    *reinterpret_cast<uint4*>(sH + swz<R>(r, cc)) = hv;
  }
  fence_async_smem();
  sync_rows();
  if constexpr (STOP == 0) return store_rows<C, R>(p, sH, row0, rtid, NSPLIT * 128, b, s0);

  {
    float acc[NSW][32];
    gemm<R, KP, NS, NSW, NSPLIT>(acc, aH, cs, ring, 0);
    for_acc<NSPLIT>(acc, row0, cs, [&](int r, int c, float v0, float v1) {
      st2(sY + swz<R>(r, c), v0 + p.b_in[c], v1 + p.b_in[c + 1]);
    });
  }
  sync_rows();
  if constexpr (STOP == 1) return store_rows<C, R>(p, sY, row0, rtid, NSPLIT * 128, b, s0);

#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    layer_norm<C, R>(sY, sH, row0, wrb, nwarps, T, TP, p.ln_s + i * C, p.ln_b + i * C, p.pe,
                     p.ln_eps);
    fence_async_smem();
    sync_rows();
    {
      float acc[NSW][32];
      gemm<R, KP, NS, NSW, NSPLIT>(acc, aH, cs, ring, 0);
      for_acc<NSPLIT>(acc, row0, cs, [&](int r, int c, float v0, float v1) { st2(sQ + swz<R>(r, c), v0, v1); });
    }
    {
      float acc[NSW][32];
      gemm<R, KP, NS, NSW, NSPLIT>(acc, aH, cs, ring, 0);
      for_acc<NSPLIT>(acc, row0, cs, [&](int r, int c, float v0, float v1) { st2(sK + swz<R>(r, c), v0, v1); });
    }
    {
      float acc[NSW][32];
      gemm<R, KP, NS, NSW, NSPLIT>(acc, aH, cs, ring, 0);
      sync_rows();  // every warpgroup of the row block is done reading h
      for_acc<NSPLIT>(acc, row0, cs, [&](int r, int c, float v0, float v1) { st2(sH + swz<R>(r, c), v0, v1); });
    }
    sync_rows();
    if constexpr (STOP == 2) return store_rows<C, R>(p, sH, row0, rtid, NSPLIT * 128, b, s0);
    if (TP == 32) frame_attention<C, R, 32>(sQ, sK, sH, row0, wrb, nwarps, p.scale, T);
    else if (TP == 16) frame_attention<C, R, 16>(sQ, sK, sH, row0, wrb, nwarps, p.scale, T);
    else frame_attention<C, R, 8>(sQ, sK, sH, row0, wrb, nwarps, p.scale, T);
    fence_async_smem();
    sync_rows();
    if constexpr (STOP == 3) return store_rows<C, R>(p, sQ, row0, rtid, NSPLIT * 128, b, s0);
    const float* bo = p.bo + i * C;
    {
      float acc[NSW][32];
      gemm<R, KP, NS, NSW, NSPLIT>(acc, aQ, cs, ring, 0);
      for_acc<NSPLIT>(acc, row0, cs, [&](int r, int c, float v0, float v1) {
        bf16* y = sY + swz<R>(r, c);
        const float2 yv = ld2(y);
        st2(y, yv.x + v0 + bo[c], yv.y + v1 + bo[c + 1]);
      });
    }
    sync_rows();
    if constexpr (STOP == 4) return store_rows<C, R>(p, sY, row0, rtid, NSPLIT * 128, b, s0);
  }
  if constexpr (STOP == 5) return store_rows<C, R>(p, sY, row0, rtid, NSPLIT * 128, b, s0);

  // GEGLU feed-forward: step f takes hidden chunk f * NSPLIT + cs (64 h
  // columns, then their 64 gate columns) in this warpgroup.  bf16(h + b1)
  // goes to panel cs of q's space, where the gate's epilogue (the same
  // thread) turns it into the activation; the second product accumulates
  // over all steps in registers.
  layer_norm<C, R>(sY, sH, row0, wrb, nwarps, T, TP, p.ln_s + 2 * C, p.ln_b + 2 * C, nullptr,
                   p.ln_eps);
  fence_async_smem();
  sync_rows();
  float ffacc[NSW][32];
#pragma unroll 1
  for (int f = 0; f < SH::FS; ++f) {
    const int j0 = (f * NSPLIT + cs) * 64;
    {
      float hacc[1][32];
      gemm<R, KP, NSPLIT, 1, NSPLIT>(hacc, aH, cs, ring, 0);
      for_acc<NSPLIT>(hacc, row0, cs, [&](int r, int c, float v0, float v1) {
        st2(sQ + swz<R>(r, c), v0 + p.b1[j0 + c % 64], v1 + p.b1[j0 + c % 64 + 1]);
      });
    }
    {
      float gacc[1][32];
      gemm<R, KP, NSPLIT, 1, NSPLIT>(gacc, aH, cs, ring, 0);
      for_acc<NSPLIT>(gacc, row0, cs, [&](int r, int c, float v0, float v1) {
        bf16* a = sQ + swz<R>(r, c);
        const float2 hh = ld2(a);
        st2(a, hh.x * gelu_bf16(bf16_round(v0 + p.b1[FF + j0 + c % 64])),
            hh.y * gelu_bf16(bf16_round(v1 + p.b1[FF + j0 + c % 64 + 1])));
      });
    }
    fence_async_smem();
    sync_rows();
    gemm<R, NSPLIT, NS, NSW, NSPLIT>(ffacc, aQ, cs, ring, f);
    sync_rows();  // every chunk read before the next step overwrites it
  }
  for_acc<NSPLIT>(ffacc, row0, cs, [&](int r, int c, float v0, float v1) {
    bf16* y = sY + swz<R>(r, c);
    const float2 yv = ld2(y);
    st2(y, yv.x + v0 + p.b2[c], yv.y + v1 + p.b2[c + 1]);
  });
  fence_async_smem();
  sync_rows();
  if constexpr (STOP == 6) return store_rows<C, R>(p, sY, row0, rtid, NSPLIT * 128, b, s0);

  // proj_out + outer residual straight to device memory
  float acc[NSW][32];
  gemm<R, KP, NS, NSW, NSPLIT>(acc, aY, cs, ring, 0);
  for_acc<NSPLIT>(acc, row0, cs, [&](int r, int c, float v0, float v1) {
    const int t = r % TP, s = s0 + r / TP;
    if (s >= S || t >= T) return;
    const long long g = ((long long)(b * T + t) * S + s) * C + c;
    const float2 x = ld2(p.x + g);
    st2(p.out + g, v0 + p.b_out[c] + x.x, v1 + p.b_out[c + 1] + x.y);
  });
}

template <int C, int STOP = 7>
int launch(const Params& p, cudaStream_t stream) {
  using SH = Shape<C>;
  if (p.TP == 0 || SH::R % p.TP) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(motion_hopper<C, STOP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int L = SH::R / p.TP;
  dim3 grid((p.S + L - 1) / L, p.B);
  motion_hopper<C, STOP><<<grid, SH::NTHREADS, SH::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

inline Params make_params(const void* x, const void* gna, const void* gnb, const void* pe,
                          const void* w, const void* b_in, const void* ln_s, const void* ln_b,
                          const void* bo, const void* b1, const void* b2, const void* b_out,
                          void* out, int B, int T, int S, float scale, float ln_eps) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.gna = static_cast<const float*>(gna);
  p.gnb = static_cast<const float*>(gnb);
  p.pe = static_cast<const bf16*>(pe);
  p.w = static_cast<const bf16*>(w);
  p.b_in = static_cast<const float*>(b_in);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.bo = static_cast<const float*>(bo);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.T = T;
  p.TP = padded_frames(T);
  p.S = S;
  p.scale = scale;
  p.ln_eps = ln_eps;
  return p;
}

}  // namespace mm

// The C entry points' arguments: x, out contiguous (B, T, S, C) bf16;
// gna/gnb (B, T, C) fp32; pe (T', C) bf16, T' >= T; w the weight blocks
// (ops/motion_module.weight_blocks for this C); biases and LayerNorm
// parameters fp32.  8 <= T <= 32; 8 heads; C in {64, 128, 192, 256,
// 384}.
#define VDA_MM_ARGS                                                                         \
  const void *x, const void *gna, const void *gnb, const void *pe, const void *w,           \
      const void *b_in, const void *ln_s, const void *ln_b, const void *bo, const void *b1, \
      const void *b2, const void *b_out, void *out, int B, int T, int S, int C, float scale, \
      float ln_eps, void *stream
#define VDA_MM_PARAMS \
  mm::make_params(x, gna, gnb, pe, w, b_in, ln_s, ln_b, bo, b1, b2, b_out, out, B, T, S, scale, ln_eps)
