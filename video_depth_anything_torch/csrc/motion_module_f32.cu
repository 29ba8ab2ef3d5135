// Kernel C on fp32 operands: one whole motion module (TemporalModule) per
// block of locations, under --fp32, with every product on the tensor cores
// in 3xTF32.
//
// Replaces video_depth_anything_tpu/ops/pallas_motion.py:_motion_kernel
// (via fused_motion_module) where the JAX package runs it on fp32 inputs:
// its gate and plan (_plan_s_blk) look at shapes alone, and its body
// computes in x's dtype (bt = x_ref.dtype), with the erf GELU where bt is
// not bf16.  Per CTA: one batch element and L = 64 / TP consecutive
// locations, 64 rows of C channels, location major (row r = l * TP + t);
// locations past S are zero rows, never stored.  TP in {8, 16, 32} is the
// frame count T (8 <= T <= 32) padded up: a location's rows t >= T are zero
// on load, their keys masked out of the frame attention, no APE row added
// to them, and neither their y nor their output is ever written to device
// memory (their residual reads 0, as a row past S does), so they cannot
// land on another frame's output.  The CTA computes
//   GroupNorm apply (statistics folded outside, as _gn_fold does) -> proj_in
//   -> 2 x [LayerNorm, +APE, q/k/v, attention over the T frames per
//           (location, head), out proj + bias, residual]
//   -> LayerNorm -> GEGLU feed-forward (erf GELU) -> residual -> proj_out
//   -> + x
// with the activations in shared memory: only x (read twice: at the start
// and for the outer residual), the folded GroupNorm, the weights and the
// output (which holds y's rows while a block reads their LayerNorm) touch
// device memory.  C in {64, 128, 192, 256, 384}, 8 heads, 8 <= T <= 32.
//
// Bound on the H100: operations.  44 * C^2 + 8 * T * C FLOP a token; the
// products (44 C^2) fp32-accurate on the tensor cores are three TF32
// products each ("3xTF32": every operand x split into hi = rna(x) and lo =
// rna(x - hi), a product lo.hi + hi.lo + hi.hi into one fp32 accumulator),
// so 3 x the FLOP at 495 TFLOP/s: 3.13 ms at vitl m3 518^2 (C = 256, 175,232
// tokens), against 7.71 ms for the same FLOP on the CUDA cores' FMA (67
// TFLOP/s) and 0.36 GB of x and output (0.11 ms).  The weights' hi and lo
// that every CTA streams from L2 are 176 C^2 bytes (11.5 MB at C = 256):
// 31.6 GB a call at vitl m3 518^2, 48 FLOP a byte of L2, so at the TF32
// rate the CTAs would read about 10 TB/s from the L2.
//
// Design (the bf16 Kernel C's skeleton, csrc/motion_module.cuh, with the
// 3xTF32 split of Kernel A fp32, csrc/flash_attention_f32.cu):
// - Rows: 64 a CTA, one wgmma M tile; NSPLIT consumer warpgroups share
//   them, each taking the 64-wide output blocks n = cs, cs + NSPLIT, ... of
//   a product, so that no warpgroup holds more than NSW = C / 64 / NSPLIT
//   accumulators of 32 floats beside the 32 of the product it runs.
// - Weights: the host splits them once (ops/motion_module.weight_blocks_f32,
//   cached by TemporalModule under the fp32 dtype) into blocks of 64 output
//   columns x 32 inputs, a K-major hi tile then a lo tile (8 KB each, the
//   128-byte swizzle of a TMA box), each warpgroup's blocks in the exact
//   order it consumes them, one sequence a warpgroup.  Within every 16
//   inputs the tiles hold the inputs in the order 0 2 4 .. 14 | 1 3 .. 15
//   by k8 step (logical j of step t is input 4 (j % 4) + 2 t + j / 4), so
//   that one 16-byte load of an activation row gives a thread its tf32 A
//   fragments of two k8 steps.  Each warpgroup streams its own sequence with
//   cp.async.bulk into its own ring of NST stages: its first thread refills
//   a stage as soon as the four warps have released it (an empty mbarrier
//   of four arrivals), so the next blocks arrive while a product computes.
//   No producer warp: ptxas budgets a CTA's registers by whole warpgroups,
//   so one beside NSPLIT consumer warpgroups would cap them at 168 (128 at
//   C = 192) instead of 255 (168), where ptxas spills and serialises the
//   wgmma; setmaxnreg does not lift that cap.
// - Products: wgmma m64n64k8 tf32, A from registers: each thread loads its
//   fp32 activations (two rows x four columns a 16-input unit) from shared
//   memory and splits them; the next unit's loads are issued before this
//   unit's products.  Three wgmma a k8 step: lo.hi, hi.lo, hi.hi.  A
//   product walks its output blocks one after another, each over all its k
//   panels, so the ring needs only two stages.  A panel's products drain
//   before its stage goes back: releasing it one unit later, to keep a unit
//   in flight across the panel's end, halves the refill's lead over the L2
//   and cost 6-32 % on an H100.
// - Shared memory: the activation rows (64 x C fp32, rows padded by 16
//   floats: conflict-free 16-byte loads) and one scratch of 64 x 192 (a
//   chunk's q | k | v, then the feed-forward's activation), and the rings.
//   Each LayerNorm (+ APE) is applied in place, once a row, before the
//   products that read it; the residual stream y waits meanwhile in the
//   CTA's own rows of the output (device memory, L2-resident: a row past S
//   waits nowhere and comes back as 0), read back in the residual's
//   epilogue.  The out projection accumulates in registers chunk by chunk
//   of q/k/v, the feed-forward's second product step by step, so no norm
//   output, attention output or second activation buffer exists.  Norms
//   applied while the A fragments are built would read the scale, bias and
//   APE from device memory for every unit of every product, and at C >= 256
//   those loads miss L1 and hold up the products.  Plan (NSPLIT, ring
//   stages a warpgroup, bytes, CTAs an SM): C = 64: 1, 2, 105 KB, 2; C =
//   128: 2, 4, 217 KB, 1; C = 192: 3, 2, 201 KB, 1; C = 256: 2, 3, 217 KB,
//   1; C = 384: 2, 2, 217 KB, 1.
// - Attention by chunks of whole heads (NCH = 64 channels at C = 64, 128
//   and 256; 48 at C = 192 and 384, their q, k and v blocks padded to 64
//   with zero weight columns, the out projection's rows with zero rows):
//   the chunk's q, k and v blocks, then FFMA in fp32, SPL (1, 2 or 4)
//   adjacent lanes per (query row, head), each over D / SPL of its
//   channels, the scores summed by shuffles (T in registers), an exact
//   softmax (max, exp2, sum), its output over the row's q slots.  Its 8 T C
//   FLOP a token are 1.5-9 % of the products', but run on the CUDA cores
//   while the tensor cores wait: all the consumer threads take part.
// MF32_STOP (1 to 4) returns after proj_in, the first attention block, the
// second, the feed-forward; MF32_NOLOAD fills the rings once and reads them
// again without waits; MF32_NOATTN skips the frame attention; MF32_ONEPASS
// issues the hi.hi products alone (bench_fp32's split builds; none is
// defined in the kernel that ships).
#include <math.h>

#include "hopper.cuh"

#ifndef MF32_STOP
#define MF32_STOP 5
#endif
#ifndef MF32_NOLOAD
#define MF32_NOLOAD 0
#endif
#ifndef MF32_NOATTN
#define MF32_NOATTN 0
#endif
#ifndef MF32_ONEPASS
#define MF32_ONEPASS 0
#endif

namespace {

constexpr int kHeads = 8;
constexpr int kRows = 64;           // rows a CTA
constexpr int kTile = 64 * 32;      // floats of a hi or lo tile: 64 output columns x 32 inputs
constexpr int kStage = 2 * kTile;   // a ring stage: the hi tile, then the lo tile (16 KB)

// consumer warpgroups, ring stages a warpgroup, CTAs an SM
template <int C>
struct Plan;
template <>
struct Plan<64> {
  static constexpr int NSPLIT = 1, NST = 2, MINB = 2;
};
template <>
struct Plan<128> {
  static constexpr int NSPLIT = 2, NST = 4, MINB = 1;
};
template <>
struct Plan<192> {
  static constexpr int NSPLIT = 3, NST = 2, MINB = 1;
};
template <>
struct Plan<256> {
  static constexpr int NSPLIT = 2, NST = 3, MINB = 1;
};
template <>
struct Plan<384> {
  static constexpr int NSPLIT = 2, NST = 2, MINB = 1;
};

template <int C>
struct Shape {
  static constexpr int NSPLIT = Plan<C>::NSPLIT, NST = Plan<C>::NST, MINB = Plan<C>::MINB;
  static constexpr int D = C / kHeads;
  static constexpr int NCH = D * (64 / D);  // channels of a chunk: whole heads, <= 64
  static constexpr int NCHK = C / NCH;      // chunks
  static constexpr int HC = NCH / D;        // heads of a chunk
  static constexpr int KP = C / 32;         // 32-wide k panels of a C-wide input
  static constexpr int NSW = C / 64 / NSPLIT;       // 64-wide output blocks a warpgroup
  static constexpr int FS = 4 * C / (64 * NSPLIT);  // feed-forward steps
  static constexpr int SY = C + 16;         // row strides (floats)
  static constexpr int SX = 3 * 64 + 16;
  static constexpr int NCONS = NSPLIT * 128;
  static constexpr int NTHREADS = NCONS;  // no producer: each warpgroup refills its own ring
  // q, k and v blocks of warpgroup cs (block n = 0, 1, 2 to cs = n % NSPLIT)
  __host__ __device__ static constexpr int nq(int cs) { return (3 - cs + NSPLIT - 1) / NSPLIT; }
  __host__ __device__ static constexpr int attn_blocks(int cs) {
    return NCHK * (nq(cs) * KP + 2 * NSW);
  }
  // blocks of warpgroup cs's sequence up to and including stage `stop`
  // (1 proj_in, 2 and 3 the attention blocks, 4 the feed-forward, 5 proj_out)
  __host__ __device__ static constexpr int blocks(int cs, int stop) {
    return (stop >= 1 ? NSW * KP : 0) + (stop >= 2 ? attn_blocks(cs) : 0) +
           (stop >= 3 ? attn_blocks(cs) : 0) +
           (stop >= 4 ? FS * (2 * KP + 2 * NSPLIT * NSW) : 0) + (stop >= 5 ? NSW * KP : 0);
  }
  __host__ __device__ static constexpr int offset(int cs) {
    return cs == 0 ? 0 : offset(cs - 1) + blocks(cs - 1, 5);
  }
  static constexpr int FLOATS = NSPLIT * NST * kStage + kRows * SY + kRows * SX;
  static constexpr int SMEM = FLOATS * 4 + 2 * NSPLIT * NST * 8 + 1024;
  static_assert(C % (64 * NSPLIT) == 0 && NSW <= 3, "even output blocks; accumulators");
  static_assert(SMEM <= 232448, "shared memory over the opt-in limit");
  static_assert(NST >= 2, "a stage in use and one filling");
};

struct Params {
  const float* x;
  const float* gna;
  const float* gnb;
  const float* pe;
  const float* w;
  const float* b_in;
  const float* ln_s;
  const float* ln_b;
  const float* bo;
  const float* b1;
  const float* b2;
  const float* b_out;
  float* out;
  int B, T, S;
  int TP;  // T padded up to 8, 16 or 32: the rows a location takes
  float scale_log2, ln_eps;
};

// A warpgroup's ring: block j of its sequence (`len` blocks from `src`) in
// stage j % NST, full and empty for the (j / NST)-th time.  The
// warpgroup's first thread fills it: the first NST blocks at the start,
// block j + NST as soon as the four warps have released block j's stage.
template <int NST>
struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  const float* src;
  int len, j;

  __device__ __forceinline__ void load(int jj) const {
    const int s = jj % NST;
    mbar_arrive_expect_tx(&full[s], kStage * 4);
    bulk_load(buf + s * kStage, src + (long long)jj * kStage, kStage * 4, &full[s]);
  }
  __device__ __forceinline__ const float* wait() const {
    if (!MF32_NOLOAD || j < NST) mbar_wait(&full[j % NST], (j / NST) & 1);
    return buf + (j % NST) * kStage;
  }
  // after this warp's products on block j are done
  __device__ __forceinline__ void release() {
    const int s = j % NST;
    if (!MF32_NOLOAD) {
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
      if ((threadIdx.x & 127) == 0 && j + NST < len) {
        mbar_wait(&empty[s], (j / NST) & 1);
        load(j + NST);
      }
    }
    ++j;
  }
};

// A thread's four columns of rows r0 and r0 + 8 at a 16-input unit
struct Quad {
  float4 a, b;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// `a`: the A buffer at (row r0, column 4 * (lane & 3)), row stride `lda`
__device__ __forceinline__ Quad load_quad(const float* a, int lda, int unit) {
  return {ld4(a + 16 * unit), ld4(a + 8 * lda + 16 * unit)};
}

// The split A fragments of the unit's two k8 steps: step t takes the
// columns 2 t and 2 t + 1 of each row's four (the tiles' input order).
__device__ __forceinline__ void split_quad(const Quad& v, uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4]) {
  const float x[2][4] = {{v.a.x, v.b.x, v.a.y, v.b.y}, {v.a.z, v.b.z, v.a.w, v.b.w}};
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      split_tf32(x[t][i], h, l);
      hi[t][i] = __float_as_uint(h);
      lo[t][i] = __float_as_uint(l);
    }
}

// Keeps the split fragments of a unit live until here (past the wait that
// ends the wgmma reading them)
__device__ __forceinline__ void keep_alive(const uint32_t (&hi)[2][4], const uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[t][i]), "r"(lo[t][i]));
}

// acc (+)= A[64 x 32 KPN] . W over the ring's next KPN blocks, one 32-input
// panel each; `accumulate` = 0 starts from zero.  Per panel: wait for the
// stage, two units of (split A, three wgmma per k8 step), the
// next unit's loads issued before the current unit's products; the stage
// is released, and refilled, once its products are done.
template <int KPN, int NST>
__device__ __forceinline__ void product(float (&acc)[32], Ring<NST>& ring, int accumulate,
                                        const float* a, int lda) {
  Quad nxt = load_quad(a, lda, 0);
#pragma unroll 1
  for (int kp = 0; kp < KPN; ++kp) {
    const float* st = ring.wait();
    const uint64_t dhi = desc_sw128(st), dlo = desc_sw128(st + kTile);
    uint32_t hi[2][2][4], lo[2][2][4];  // [unit][k8 step][fragment]
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const Quad v = nxt;
      if (q == 0 || kp + 1 < KPN) nxt = load_quad(a, lda, 2 * kp + q + 1);
      split_quad(v, hi[q], lo[q]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kk = 2 * q + t;
        if (!MF32_ONEPASS) {
          wgmma_tf32_rs_n64(acc, lo[q][t], dhi + 2 * kk, (accumulate | kp | q | t) ? 1 : 0);
          wgmma_tf32_rs_n64(acc, hi[q][t], dlo + 2 * kk, 1);
        }
        wgmma_tf32_rs_n64(acc, hi[q][t], dhi + 2 * kk,
                          (!MF32_ONEPASS || accumulate | kp | q | t) ? 1 : 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    keep_alive(hi[0], lo[0]);
    keep_alive(hi[1], lo[1]);
    ring.release();
  }
  fence_regs(acc);
}

// epi(row, col, v0, v1) over an m64n64 accumulator (hopper.cuh's layout),
// columns from n0
template <typename Epi>
__device__ __forceinline__ void for_acc(const float (&acc)[32], int n0, Epi epi) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      epi(warp * 16 + (lane >> 2) + 8 * h, n0 + t * 8 + (lane & 3) * 2, acc[4 * t + 2 * h],
          acc[4 * t + 2 * h + 1]);
}

// LayerNorm i of the rows in place (+ the APE row of the row's frame), warp
// per row: fp32 mean and E[x^2] - mean^2 clamped at 0, as
// ops/motion_module._ln; y itself to the row's place in out (rows past S
// and padded frames: nowhere).  The APE row only where t < T.
template <int C>
__device__ __forceinline__ void norm_rows(float* sY, const Params& p, int i, bool ape, int ctid,
                                          int b, int s0) {
  constexpr int SY = Shape<C>::SY, NV = C / 32;
  const int lane = ctid & 31, T = p.T, TP = p.TP;
  const float* g = p.ln_s + i * C;
  const float* bi = p.ln_b + i * C;
  for (int r = ctid >> 5; r < kRows; r += Shape<C>::NCONS / 32) {
    float v[NV];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = sY[r * SY + lane + 32 * j];
      sum += v[j];
      sq = fmaf(v[j], v[j], sq);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    const float mean = sum / C;
    const float rstd = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + p.ln_eps);
    const int t = r % TP, s = s0 + r / TP;
    const bool real = s < p.S && t < T;
    float* yo = p.out + ((long long)(b * T + t) * p.S + s) * C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (real) yo[c] = v[j];
      float h = fmaf(v[j] - mean, rstd * g[c], bi[c]);
      if (ape && t < T) h += p.pe[t * C + c];
      sY[r * SY + c] = h;
    }
  }
}

// y + (v + bias) at (row, col..col + 1), y from the row's place in out (0
// past S and on padded frames)
__device__ __forceinline__ float2 residual(const Params& p, int b, int s0, int r, int c, float v0,
                                           float v1, const float* bias, int C) {
  const int t = r % p.TP, s = s0 + r / p.TP;
  float2 y = make_float2(0.f, 0.f);
  if (s < p.S && t < p.T)
    y = *reinterpret_cast<const float2*>(p.out + ((long long)(b * p.T + t) * p.S + s) * C + c);
  return make_float2(y.x + (v0 + bias[c]), y.y + (v1 + bias[c + 1]));
}

// The chunk's frame attention: SPL adjacent lanes per (query row, head),
// each over DS = D / SPL of its channels; q, k and v at columns 0, 64 and
// 128 of the scratch; the output over the row's q.  A location's TP rows;
// key frames t >= T score -inf before the max (p = 0).
template <int C, int TP>
__device__ __forceinline__ void frame_attention(float* sX, int ctid, float scale_log2, int T) {
  using SH = Shape<C>;
  constexpr int D = SH::D, SX = SH::SX, NCONS = SH::NCONS, UNITS = kRows * SH::HC;
  constexpr int SPL = NCONS >= 4 * UNITS && D % 16 == 0   ? 4
                      : NCONS >= 2 * UNITS && D % 8 == 0 ? 2
                                                         : 1;
  constexpr int DS = D / SPL;
  for (int i = ctid; i < UNITS * SPL; i += NCONS) {
    const int u = i / SPL, hh = u / kRows, r = u % kRows, base = (r / TP) * TP;
    const int col = hh * D + (i % SPL) * DS;
    float* qr = sX + r * SX + col;
    float4 q[DS / 4];
#pragma unroll
    for (int e = 0; e < DS / 4; ++e) q[e] = ld4(qr + 4 * e);
    float s[TP];
#pragma unroll
    for (int kf = 0; kf < TP; ++kf) {
      const float* kr = sX + (base + kf) * SX + 64 + col;
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int e = 0; e < DS / 4; ++e) {
        const float4 kv = ld4(kr + 4 * e);
        d.x = fmaf(q[e].x, kv.x, d.x);
        d.y = fmaf(q[e].y, kv.y, d.y);
        d.z = fmaf(q[e].z, kv.z, d.z);
        d.w = fmaf(q[e].w, kv.w, d.w);
      }
      s[kf] = (d.x + d.y) + (d.z + d.w);
    }
#pragma unroll
    for (int kf = 0; kf < TP; ++kf) {
      if (SPL > 1) s[kf] += __shfl_xor_sync(0xffffffffu, s[kf], 1);
      if (SPL > 2) s[kf] += __shfl_xor_sync(0xffffffffu, s[kf], 2);
      s[kf] = kf < T ? s[kf] * scale_log2 : -INFINITY;
    }
    float m = s[0];
#pragma unroll
    for (int kf = 1; kf < TP; ++kf) m = fmaxf(m, s[kf]);
    float l = 0.f;
#pragma unroll
    for (int kf = 0; kf < TP; ++kf) {
      s[kf] = exp2f(s[kf] - m);
      l += s[kf];
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < DS / 4; ++e) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kf = 0; kf < TP; ++kf) {
        const float4 vv = ld4(sX + (base + kf) * SX + 128 + col + 4 * e);
        o.x = fmaf(s[kf], vv.x, o.x);
        o.y = fmaf(s[kf], vv.y, o.y);
        o.z = fmaf(s[kf], vv.z, o.z);
        o.w = fmaf(s[kf], vv.w, o.w);
      }
      *reinterpret_cast<float4*>(qr + 4 * e) =
          make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(Shape<C>::NTHREADS, Shape<C>::MINB) motion_f32(const Params p) {
  using SH = Shape<C>;
  constexpr int NSPLIT = SH::NSPLIT, NST = SH::NST, NSW = SH::NSW, KP = SH::KP;
  constexpr int SY = SH::SY, SX = SH::SX, NCONS = SH::NCONS;
  constexpr int STOP = MF32_STOP < 5 ? MF32_STOP : 5;
  extern __shared__ unsigned char smem_raw[];
  float* ring_buf = &aligned_smem<float>(smem_raw);
  float* sY = ring_buf + NSPLIT * NST * kStage;  // y, or its LayerNorm while a block reads it
  float* sX = sY + kRows * SY;                   // a chunk's q | k | v; the FF activation
  uint64_t* full = reinterpret_cast<uint64_t*>(sX + kRows * SX);
  uint64_t* empty = full + NSPLIT * NST;
  const int T = p.T, TP = p.TP, S = p.S;
  const int b = blockIdx.y, s0 = blockIdx.x * (kRows / TP);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSPLIT * NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // the owner warpgroup's four warps
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int cs = threadIdx.x >> 7, ctid = threadIdx.x;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c4 = 4 * (lane & 3);  // rows r0, r0 + 8; columns c4..
  Ring<NST> ring{ring_buf + cs * NST * kStage, full + cs * NST, empty + cs * NST,
                 p.w + (long long)SH::offset(cs) * kStage, SH::blocks(cs, STOP), 0};
  if ((threadIdx.x & 127) == 0)
    for (int j = 0; j < NST && j < ring.len; ++j) ring.load(j);
  auto sync_all = [] { bar_sync(1, NCONS); };
  auto stop_here = [&] {  // a split build's end: keep the stages before it
    sync_all();
    if (ctid < C) p.out[(long long)blockIdx.x * C + ctid] = sY[ctid];
  };
  const float* aY = sY + r0 * SY + c4;  // this thread's A rows and columns
  const float* aX = sX + r0 * SX + c4;

  // GroupNorm apply with the folded per-(b, t, c) scale and shift; a
  // padded frame's rows are zero
  for (int i = ctid; i < kRows * C / 4; i += NCONS) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const int t = r % TP, s = s0 + r / TP;
    if (t >= T) {
      *reinterpret_cast<float4*>(sY + r * SY + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) xv = ld4(p.x + ((long long)(b * T + t) * S + s) * C + c);
    const float4 ga = ld4(p.gna + (long long)(b * T + t) * C + c);
    const float4 gb = ld4(p.gnb + (long long)(b * T + t) * C + c);
    *reinterpret_cast<float4*>(sY + r * SY + c) =
        make_float4(fmaf(xv.x, ga.x, gb.x), fmaf(xv.y, ga.y, gb.y), fmaf(xv.z, ga.z, gb.z),
                    fmaf(xv.w, ga.w, gb.w));
  }
  sync_all();

  {  // proj_in, in place: every warpgroup reads all of h before any writes y
    float acc[NSW][32];
#pragma unroll
    for (int u = 0; u < NSW; ++u) product<KP, NST>(acc[u], ring, 0, aY, SY);
    sync_all();
#pragma unroll
    for (int u = 0; u < NSW; ++u)
      for_acc(acc[u], (cs + u * NSPLIT) * 64, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(sY + r * SY + c) =
            make_float2(v0 + p.b_in[c], v1 + p.b_in[c + 1]);
      });
  }
  if constexpr (STOP == 1) return stop_here();

#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    if (STOP == 2 && i == 1) return stop_here();
    sync_all();
    norm_rows<C>(sY, p, i, true, ctid, b, s0);  // h = LN(y) + APE; y to out
    sync_all();
    float acc_o[NSW][32];
#pragma unroll 1
    for (int ch = 0; ch < SH::NCHK; ++ch) {
      // this warpgroup's blocks of the chunk's q | k | v
#pragma unroll 1
      for (int n = cs; n < 3; n += NSPLIT) {
        float acc[32];
        product<KP, NST>(acc, ring, 0, aY, SY);
        for_acc(acc, n * 64, [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(sX + r * SX + c) = make_float2(v0, v1);
        });
      }
      sync_all();
      if (MF32_NOATTN) {
      } else if (TP == 32) {
        frame_attention<C, 32>(sX, ctid, p.scale_log2, T);
      } else if (TP == 16) {
        frame_attention<C, 16>(sX, ctid, p.scale_log2, T);
      } else {
        frame_attention<C, 8>(sX, ctid, p.scale_log2, T);
      }
      sync_all();
      // the chunk's rows of the out projection (64 inputs: q's columns,
      // zero weight rows past the chunk's channels)
#pragma unroll
      for (int u = 0; u < NSW; ++u) product<2, NST>(acc_o[u], ring, ch, aX, SX);
      sync_all();  // every warpgroup has read the chunk before the next overwrites it
    }
    const float* bo = p.bo + i * C;
#pragma unroll
    for (int u = 0; u < NSW; ++u)
      for_acc(acc_o[u], (cs + u * NSPLIT) * 64, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(sY + r * SY + c) = residual(p, b, s0, r, c, v0, v1, bo, C);
      });
  }
  if constexpr (STOP == 3) return stop_here();

  // GEGLU feed-forward on LN(y) (y to out): step f takes hidden chunk
  // f * NSPLIT + cs (64 h columns, then their 64 gate columns) in this
  // warpgroup, its activation to columns 64 cs of the scratch; the second
  // product accumulates over all steps in registers.
  sync_all();
  norm_rows<C>(sY, p, 2, false, ctid, b, s0);
  sync_all();
  float acc_f[NSW][32];
#pragma unroll 1
  for (int f = 0; f < SH::FS; ++f) {
    const int j0 = (f * NSPLIT + cs) * 64;
    {
      float acc[32];
      product<KP, NST>(acc, ring, 0, aY, SY);
      for_acc(acc, cs * 64, [&](int r, int c, float v0, float v1) {
        const int h = j0 + c - cs * 64;
        *reinterpret_cast<float2*>(sX + r * SX + c) = make_float2(v0 + p.b1[h], v1 + p.b1[h + 1]);
      });
    }
    {
      float acc[32];
      product<KP, NST>(acc, ring, 0, aY, SY);
      for_acc(acc, cs * 64, [&](int r, int c, float v0, float v1) {
        const int h = 4 * C + j0 + c - cs * 64;
        float2* a = reinterpret_cast<float2*>(sX + r * SX + c);
        const float2 hv = *a;
        const float g0 = v0 + p.b1[h], g1 = v1 + p.b1[h + 1];
        *a = make_float2(hv.x * (0.5f * g0 * (1.f + erff(g0 * 0.70710678118654752f))),
                         hv.y * (0.5f * g1 * (1.f + erff(g1 * 0.70710678118654752f))));
      });
    }
    sync_all();
#pragma unroll
    for (int u = 0; u < NSW; ++u) product<2 * NSPLIT, NST>(acc_f[u], ring, f, aX, SX);
    sync_all();  // every activation read before the next step overwrites it
  }
#pragma unroll
  for (int u = 0; u < NSW; ++u)
    for_acc(acc_f[u], (cs + u * NSPLIT) * 64, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(sY + r * SY + c) = residual(p, b, s0, r, c, v0, v1, p.b2, C);
    });
  if constexpr (STOP == 4) return stop_here();
  sync_all();

  // proj_out, + x, straight to device memory (over y's rows there)
  float acc[NSW][32];
#pragma unroll
  for (int u = 0; u < NSW; ++u) product<KP, NST>(acc[u], ring, 0, aY, SY);
#pragma unroll
  for (int u = 0; u < NSW; ++u)
    for_acc(acc[u], (cs + u * NSPLIT) * 64, [&](int r, int c, float v0, float v1) {
      const int t = r % TP, s = s0 + r / TP;
      if (s >= S || t >= T) return;
      const long long o = ((long long)(b * T + t) * S + s) * C + c;
      const float2 xv = *reinterpret_cast<const float2*>(p.x + o);
      *reinterpret_cast<float2*>(p.out + o) =
          make_float2(v0 + p.b_out[c] + xv.x, v1 + p.b_out[c + 1] + xv.y);
    });
}

template <int C>
int launch(const Params& p, cudaStream_t st) {
  using SH = Shape<C>;
  const cudaError_t err =
      cudaFuncSetAttribute(motion_f32<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = kRows / p.TP;
  dim3 grid((p.S + L - 1) / L, p.B);
  motion_f32<C><<<grid, SH::NTHREADS, SH::SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, T, S, C) fp32; gna/gnb (B, T, C) fp32; pe (T', C) fp32, T' >=
// T; w the hi/lo weight blocks (ops/motion_module.weight_blocks_f32 for this
// C); b_in, b2, b_out (C,), ln_s/ln_b (3, C), bo (2, C), b1 (8C,) fp32.
extern "C" int vda_motion_module_f32(const void* x, const void* gna, const void* gnb,
                                     const void* pe, const void* w, const void* b_in,
                                     const void* ln_s, const void* ln_b, const void* bo,
                                     const void* b1, const void* b2, const void* b_out, void* out,
                                     int B, int T, int S, int C, float scale, float ln_eps,
                                     void* stream) {
  if (T < 8 || T > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  Params p;
  p.x = static_cast<const float*>(x);
  p.gna = static_cast<const float*>(gna);
  p.gnb = static_cast<const float*>(gnb);
  p.pe = static_cast<const float*>(pe);
  p.w = static_cast<const float*>(w);
  p.b_in = static_cast<const float*>(b_in);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.bo = static_cast<const float*>(bo);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.T = T;
  p.TP = T <= 8 ? 8 : T <= 16 ? 16 : 32;
  p.S = S;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.ln_eps = ln_eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch<64>(p, st);
    case 128: return launch<128>(p, st);
    case 192: return launch<192>(p, st);
    case 256: return launch<256>(p, st);
    case 384: return launch<384>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
