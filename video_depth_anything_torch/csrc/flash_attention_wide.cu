// Kernel A's forward at the head widths past D = 192 that its JAX gate
// admits: D = 320, 448, 576, ... (a multiple of 64, not of 128), in bf16
// (vda_flash_attention_wide) and in fp32 (vda_flash_attention_wide_f32)
// from one source templated on the element type.
//
// Replaces video_depth_anything_tpu/ops/pallas_attention.py:
// _flash_kernel_single (the whole-row kernel, padded N <= 2048) and
// _flash_kernel / _flash_kernel_fast (the blocked 512-key kernels past
// that), which spatial_flash_attention runs at every D != 64 that
// try_spatial_attention admits.  It computes what they compute:
// softmax(q k^T D^-1/2) v per (batch, head) on (B, N, H, D) operands that
// may be strided views of the fused qkv projection, fp32 scores, softmax
// and accumulate; in bf16 p is rounded to bf16 before P V (as in
// flash_attention_plain), in fp32 it stays fp32 and both products are
// fp32-accurate (3xTF32).  Exact (a running max) or FAST (the ':fast'
// no-max softmax, exact while the scaled logits stay inside fp32's exp2
// domain, about +-88, as at D = 64 and 192).  Any N >= 1; the zero-filled
// pad keys of the ragged last key tile are masked to -inf, pad query rows
// are computed on zeros and never stored.  No log-sum-exp: the JAX VJP at
// D != 64 is the dense einsum backward (pallas_attention.py:490-523), so
// no backward kernel reads one.  The TPU kernels' ones-column row sum
// (_flash_forward, :533-548) is a VPU workaround and is not carried over.
//
// Bound on the H100: operations.  The dense work is 4 N^2 D H B FLOP (at
// 989 TFLOP/s in bf16; in fp32 three TF32 products each at 495).  This
// plan computes S once for every 320-column slice of O (below) and P V
// over whole slices, (2 N^2 D + 2 N^2 320) ceil(D / 320) H B FLOP: the
// dense work at D = 320, 1.71x at 448, 4.06x at 1984.
//
// Design (the skeleton of flash_fwd_hopper192 and flash_fwd_f32):
// - A CTA is one (b, h), 64 query rows and one 320-column slice of O: a
//   producer warpgroup (one thread issues the TMA loads) and one consumer
//   warpgroup that keeps its rows' slice of O, five 64-column panels, in
//   160 fp32 registers a thread, so S is computed once a slice: once at D
//   = 320, ceil(D / 320) times past it.  256 threads, so ptxas may give the
//   consumer up to 255 registers (it uses 218-232); with two consumers of
//   64 rows (384 threads) ptxas holds every thread to 168 registers,
//   setmaxnreg or not, and each could keep only 192 columns (S twice at D
//   = 320: slower on the H100, PERF.md).  The last slice starts at panel
//   D / 64 - 5 (it overlaps the one before it, and stores only the panels
//   that one left).  Grid: (query blocks x slices, B H), the slices of one
//   query block adjacent in the L2.
// - Every operand arrives by TMA in the 128-byte swizzle (rows past N
//   zero-filled) through one ring of `stages` stages with full and empty
//   mbarriers; every consumer thread arrives on a stage's empty barrier
//   once the wgmma that read it has been waited for.  Per key tile the
//   steps are D / CP S-steps (one K panel each: 64 keys x 64 columns in
//   bf16, 32 keys x 32 floats hi and lo in fp32) and then five V-steps
//   (one 64-column panel of V, or of V^T hi and lo).  A stage is a few KB
//   whatever D is.
// - Q is loaded once per CTA and stays in shared memory where it fits
//   beside at least kMinStages stages (bf16 D <= 1344: 8 KB a 64-column
//   panel of 64 rows); past that, and in fp32 (whose Q hi and lo, 160 KB at
//   D = 320, would leave four stages: slower on the H100, PERF.md), each
//   S-step also carries the Q panel.
// - The consumer waits for a batch of landed stages (up to gs S-steps, half
//   the ring, or the five V-steps), then issues the batch's products back
//   to back, waits for them and releases the stages: no wgmma is in flight
//   across an mbarrier wait, and the producer fills the other half of the
//   ring meanwhile.  S = sum over the panels of Q_p K_p^T: bf16 wgmma
//   m64n64k16, fp32 three passes (lo.hi, hi.lo, hi.hi) of tf32 wgmma
//   m64n32k8, both operands K-major in shared memory.  Then the online
//   softmax on the accumulator in registers (running max and rescale by
//   exp2(m_old - m_new); FAST keeps m = 0); only the ragged last key tile
//   is masked (a zero-filled pad key scores 0, not -inf).  O_slice += P V:
//   bf16 wgmma m64n64k16 with P from registers as bf16 A fragments and V
//   MN-major (transpose bit); fp32 three tf32 m64n64k8 passes with P split
//   into hi and lo A fragments in registers and V^T hi / lo K-major.
// - ptxas serialises the wgmma where it cannot tell a branch is uniform
//   across the warpgroup (the warpgroup index goes through a shuffle, as
//   in CUTLASS) and where a non-wgmma instruction may define an
//   accumulator between a wgmma and its wait (S is zeroed before its
//   products instead of by a run-time scale_d = 0).
// - fp32: tf32 wgmma reads raw fp32 truncated and takes no transposed
//   operand, so a pre-pass (split_rows, split_vt) writes q * scale *
//   log2(e), k and v^T rounded into hi = rna(x) and lo = rna(x - hi),
//   into scratch that the wrapper allocates: q and k as (B, N, H, D), v^T
//   as (B, D, H, Np) with Np = N padded to 32 keys (zeros past N) and the
//   keys of each group of 8 permuted (position j holds key 2j for j < 4,
//   key 2(j - 4) + 1 after), so that S's accumulator columns (2c, 2c + 1)
//   are P's tf32 A fragment (c, c + 4) with no shuffle.  The main kernel
//   is then TMA -> wgmma only, as in bf16.
#include <limits.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxStages = 24;    // barriers reserved for the ring
constexpr int kSmemLimit = 232448;  // the 227 KB a block may have
constexpr int kBarBytes = (2 * kMaxStages + 1) * 8;
constexpr int kMinStages = 6;     // Q resident only beside this many stages

template <typename E>
struct Tr;
template <>
struct Tr<bf16> {
  static constexpr int KT = 64;  // keys a tile
  static constexpr int CP = 64;  // columns of a 128-byte S panel
  static constexpr int SPLITS = 1;  // copies of each operand (fp32: hi and lo)
  static constexpr int K_BYTES = KT * CP * 2;  // an S-step's K panel: 8 KB
  static constexpr int V_BYTES = KT * 64 * 2;  // a V-step: 64 keys x 64 columns
};
template <>
struct Tr<float> {
  static constexpr int KT = 32;
  static constexpr int CP = 32;
  static constexpr int SPLITS = 2;
  static constexpr int K_BYTES = 2 * KT * CP * 4;  // K hi, K lo: 8 KB
  static constexpr int V_BYTES = 2 * 64 * KT * 4;  // V^T hi, lo (64 columns x 32 keys)
};

constexpr int NP = 5;  // 64-column panels of O the consumer keeps: 320 columns

// The ring for Q resident (QRES) or not.  Q_PANEL: a 128-byte column panel
// of the CTA's 64 query rows (fp32: hi, then lo); SB: a stage's bytes, an
// S-step's K panel (and Q panel where Q is not resident) or a V-step's
// panel, whichever is larger.
template <typename E, bool QRES>
struct Ring {
  using T = Tr<E>;
  static constexpr int Q_PANEL = 64 * 128 * T::SPLITS;
  static constexpr int S_STEP = QRES ? T::K_BYTES : T::K_BYTES + Q_PANEL;
  static constexpr int SB = S_STEP > T::V_BYTES ? S_STEP : T::V_BYTES;
};

struct Params {
  void* o;
  int n, heads, sp, op, slices, stages, gs, bh;  // sp: S panels (D / CP); op: O panels (D / 64);
                                                 // gs: S-steps a consumer waits for at once
  long long os[3];                               // o's (b, n, h) element strides
  float scale_log2;                              // D^-0.5 log2(e) in bf16; 1 in fp32 (q pre-scaled)
};

// ---- the products ----
// S += Q panel . K panel^T: q the consumer's 64 rows of the panel, st the
// stage (K, or K hi then K lo at +4 KB).
__device__ __forceinline__ void s_panel(float (&sc)[32], const unsigned char* q,
                                        const unsigned char* st) {
  const uint64_t dq = desc_sw128(q), dk = desc_sw128(st);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(sc, dq + 2 * kk, dk + 2 * kk, 1);
}

__device__ __forceinline__ void s_panel(float (&sc)[16], const unsigned char* q,
                                        const unsigned char* st) {
  const uint64_t dqh = desc_sw128(q), dql = desc_sw128(q + 8192);
  const uint64_t dkh = desc_sw128(st), dkl = desc_sw128(st + 4096);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_ss_n32(sc, dql + 2 * kk, dkh + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_ss_n32(sc, dqh + 2 * kk, dkl + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_ss_n32(sc, dqh + 2 * kk, dkh + 2 * kk, 1);
}

// P as the P V product's A operand, from the exponentials in S's registers:
// bf16 pairs (16 keys a k16 step), or tf32 hi and lo (8 keys a k8 step,
// keys permuted as V^T's).
template <typename E>
struct PFrag;
template <>
struct PFrag<bf16> {
  uint32_t a[4][4];
  __device__ __forceinline__ void set(const float (&p)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
  }
};
template <>
struct PFrag<float> {
  uint32_t hi[4][4], lo[4][4];
  __device__ __forceinline__ void set(const float (&p)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float h, l;
      split_tf32(p[i], h, l);
      const int r = ((i & 1) << 1) | ((i >> 1) & 1);
      hi[i >> 2][r] = __float_as_uint(h);
      lo[i >> 2][r] = __float_as_uint(l);
    }
  }
};

// acc (one 64-column panel of O) += P V-step: st holds V (64 keys x 64
// columns, MN-major) or V^T hi then V^T lo at +8 KB (64 columns x 32 keys).
__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<bf16>& pf,
                                         const unsigned char* st) {
  const uint64_t dv = desc_sw128(st);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(acc, pf.a[kk], dv + 128 * kk, 1);
}

__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<float>& pf,
                                         const unsigned char* st) {
  const uint64_t dvh = desc_sw128(st), dvl = desc_sw128(st + 8192);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n64(acc, pf.lo[kk], dvh + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n64(acc, pf.hi[kk], dvl + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n64(acc, pf.hi[kk], dvh + 2 * kk, 1);
}

// The online softmax of one key tile on S's accumulator (rows g and g + 8
// of each warp's 16; key (i >> 2) * 8 + c2 + (i & 1) of sc[i]): pad keys
// past `valid` to -inf, the running max and the rescale of acc and l
// (exact), then p = exp2(s * scale_log2 - m) in place and l += p.
template <bool FAST, int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&acc)[NP][32],
                                             float (&m_i)[2], float (&l_i)[2], int valid, int c2,
                                             float scale_log2) {
  if (valid < 2 * NS) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if ((i >> 2) * 8 + c2 + (i & 1) >= valid) sc[i] = -INFINITY;
  }
  if constexpr (!FAST) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_i[rr], mx[rr] * scale_log2);
      const float alpha = exp2_approx(m_i[rr] - m_new);
      m_i[rr] = m_new;
      l_i[rr] *= alpha;
#pragma unroll
      for (int t = 0; t < NP; ++t)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[t][4 * e + 2 * rr] *= alpha;
          acc[t][4 * e + 2 * rr + 1] *= alpha;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -m_i[(i >> 1) & 1]));
    l_i[(i >> 1) & 1] += sc[i];
  }
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// ---- the loads (the producer's one thread) ----
// Q panel c of the CTA's rows into dst: bf16 128 rows x 64 columns; fp32
// 64 rows x 32 floats, hi then lo at +8 KB.
__device__ __forceinline__ void load_q(bf16*, unsigned char* dst, const CUtensorMap* tq,
                                       const CUtensorMap*, uint64_t* bar, int c, int h, int q0,
                                       int b) {
  tma_load_4d(dst, tq, bar, 64 * c, h, q0, b);
}
__device__ __forceinline__ void load_q(float*, unsigned char* dst, const CUtensorMap* tq,
                                       const CUtensorMap* tq_lo, uint64_t* bar, int c, int h,
                                       int q0, int b) {
  tma_load_4d(dst, tq, bar, 32 * c, h, q0, b);
  tma_load_4d(dst + 8192, tq_lo, bar, 32 * c, h, q0, b);
}
// K panel c of key tile j: bf16 64 keys x 64 columns; fp32 32 keys x 32
// floats, hi then lo at +4 KB.
__device__ __forceinline__ void load_k(bf16*, unsigned char* dst, const CUtensorMap* tk,
                                       const CUtensorMap*, uint64_t* bar, int c, int h, int j,
                                       int b) {
  tma_load_4d(dst, tk, bar, 64 * c, h, 64 * j, b);
}
__device__ __forceinline__ void load_k(float*, unsigned char* dst, const CUtensorMap* tk,
                                       const CUtensorMap* tk_lo, uint64_t* bar, int c, int h,
                                       int j, int b) {
  tma_load_4d(dst, tk, bar, 32 * c, h, 32 * j, b);
  tma_load_4d(dst + 4096, tk_lo, bar, 32 * c, h, 32 * j, b);
}
// O panel c's V-step of key tile j: bf16 V's 64 keys x 64 columns; fp32
// V^T's 64 rows (columns of O) x 32 keys, hi then lo at +8 KB.
__device__ __forceinline__ void load_v(bf16*, unsigned char* dst, const CUtensorMap* tv,
                                       const CUtensorMap*, uint64_t* bar, int c, int h, int j,
                                       int b) {
  tma_load_4d(dst, tv, bar, 64 * c, h, 64 * j, b);
}
__device__ __forceinline__ void load_v(float*, unsigned char* dst, const CUtensorMap* tv,
                                       const CUtensorMap* tv_lo, uint64_t* bar, int c, int h,
                                       int j, int b) {
  tma_load_4d(dst, tv, bar, 32 * j, h, 64 * c, b);
  tma_load_4d(dst + 8192, tv_lo, bar, 32 * j, h, 64 * c, b);
}

template <typename E, bool FAST, bool QRES>
__global__ void __launch_bounds__(256, 1) flash_wide(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tq_lo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tk_lo,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tv_lo,
    const Params p) {
  using T = Tr<E>;
  using L = Ring<E, QRES>;
  constexpr int SB = L::SB;
  constexpr int NS = T::KT / 2;  // S accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = &aligned_smem<unsigned char>(smem_raw);  // resident Q panels
  unsigned char* ring = qs + (QRES ? p.sp * L::Q_PANEL : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * SB);
  uint64_t* empty = full + kMaxStages;
  uint64_t* q_full = empty + kMaxStages;
  // the warpgroup index through a shuffle: ptxas then knows each branch
  // below is uniform across every warp (else it serialises the wgmma)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.y + blockIdx.z * gridDim.y;
  if (bh >= p.bh) return;
  const int b = bh / p.heads, h = bh % p.heads;
  const int slice = blockIdx.x % p.slices, q0 = (blockIdx.x / p.slices) * 64;
  const int c0 = min(slice * NP, p.op - NP);  // the slice's first O panel
  const int n_tiles = (p.n + T::KT - 1) / T::KT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // every consumer thread
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: Q once (where resident), then each tile's S- and V-steps
    if (tid == 0) {
      if constexpr (QRES) {
        mbar_arrive_expect_tx(q_full, p.sp * L::Q_PANEL);
        for (int c = 0; c < p.sp; ++c)
          load_q(static_cast<E*>(nullptr), qs + c * L::Q_PANEL, &tq, &tq_lo, q_full, c, h, q0, b);
      }
      int s = 0, i = 0;
      uint32_t ph = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int c = 0; c < p.sp + NP; ++c, ++i) {
          if (i >= p.stages) mbar_wait(&empty[s], ph ^ 1);  // the step stages back is read
          unsigned char* st = ring + s * SB;
          if (c < p.sp) {
            mbar_arrive_expect_tx(&full[s], L::S_STEP);
            load_k(static_cast<E*>(nullptr), st, &tk, &tk_lo, &full[s], c, h, j, b);
            if constexpr (!QRES)
              load_q(static_cast<E*>(nullptr), st + T::K_BYTES, &tq, &tq_lo, &full[s], c, h, q0, b);
          } else {
            mbar_arrive_expect_tx(&full[s], T::V_BYTES);
            load_v(static_cast<E*>(nullptr), st, &tv, &tv_lo, &full[s], c0 + c - p.sp, h, j, b);
          }
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // the consumer
    const int warp = tid >> 5, lane = tid & 31, c2 = (lane & 3) * 2;
    // Under FAST the running max stays 0: no max pass and no rescale.
    float m_i[2] = {FAST ? 0.f : -INFINITY, FAST ? 0.f : -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float acc[NP][32];
#pragma unroll
    for (int t = 0; t < NP; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
    if constexpr (QRES) mbar_wait(q_full, 0);
    int s = 0;
    uint32_t ph = 0;
    const auto next = [&](int& s_, uint32_t& ph_) {
      if (++s_ == p.stages) {
        s_ = 0;
        ph_ ^= 1;
      }
    };

    for (int j = 0; j < n_tiles; ++j) {
      // S over the panels, in batches of gs S-steps: every stage of the batch
      // waited for, then its products issued back to back (no wgmma in flight
      // across a wait), waited for, and the stages released
      // S starts at zero outside the products: a run-time scale_d = 0 on the
      // first would leave ptxas a loop-carried accumulator to move, and it
      // serialises the wgmma
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      for (int c = 0; c < p.sp; c += p.gs) {
        const int cnt = min(p.gs, p.sp - c);
        int s1 = s;
        uint32_t ph1 = ph;
        for (int i = 0; i < cnt; ++i) {
          mbar_wait(&full[s1], ph1);
          next(s1, ph1);
        }
        s1 = s;
        for (int i = 0; i < cnt; ++i) {  // a fence each pass: ptxas adds none on the loop's path
          const unsigned char* st = ring + s1 * SB;
          wgmma_fence();
          s_panel(sc, QRES ? qs + (c + i) * L::Q_PANEL : st + T::K_BYTES, st);
          s1 = s1 + 1 == p.stages ? 0 : s1 + 1;
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        for (int i = 0; i < cnt; ++i) {
          mbar_arrive(&empty[s]);
          next(s, ph);
        }
      }

      softmax_tile<FAST>(sc, acc, m_i, l_i, p.n - j * T::KT, c2, p.scale_log2);
      PFrag<E> pf;
      pf.set(sc);

      // O's five panels: their V-steps waited for, the products issued, the same way
      int s1 = s;
      uint32_t ph1 = ph;
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        mbar_wait(&full[s1], ph1);
        next(s1, ph1);
      }
      s1 = s;
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        wgmma_fence();
        pv_panel(acc[t], pf, ring + s1 * SB);
        s1 = s1 + 1 == p.stages ? 0 : s1 + 1;
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        fence_regs(acc[t]);
        mbar_arrive(&empty[s]);
        next(s, ph);
      }
    }

    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_i[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[rr] = 1.f / l;
    }
    const int r0 = q0 + warp * 16 + (lane >> 2);
    E* ob = static_cast<E*>(p.o) + b * p.os[0] + h * p.os[2];
#pragma unroll
    for (int t = 0; t < NP; ++t) {
      if (c0 + t < slice * NP) continue;  // an earlier slice stored it
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = (c0 + t) * 64 + e * 8 + c2;
        if (r0 < p.n)
          store2(ob + r0 * p.os[1] + col, acc[t][4 * e] * inv[0], acc[t][4 * e + 1] * inv[0]);
        if (r0 + 8 < p.n)
          store2(ob + (r0 + 8) * p.os[1] + col, acc[t][4 * e + 2] * inv[1],
                 acc[t][4 * e + 3] * inv[1]);
      }
    }
  }
}

// ---- the fp32 pre-pass ----
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// x (a (B, N, H, D) view, the given (b, n, h) element strides) * mul into
// hi and lo, contiguous (B, N, H, D); d4 = D / 4.
__global__ void split_rows(const float* __restrict__ x, long long sb, long long sn, long long sh,
                           float mul, float* __restrict__ hi, float* __restrict__ lo, int n,
                           int heads, int d4, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int dq = static_cast<int>(i % d4);
    long long r = i / d4;
    const int h = static_cast<int>(r % heads);
    r /= heads;
    const long long t = r % n, b = r / n;
    float4 v = *reinterpret_cast<const float4*>(x + b * sb + t * sn + h * sh + 4 * dq);
    v = make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul);
    float4 vh, vl;
    split4(v, vh, vl);
    reinterpret_cast<float4*>(hi)[i] = vh;
    reinterpret_cast<float4*>(lo)[i] = vl;
  }
}

// v (a (B, N, H, D) view) -> v^T hi and lo, (B, D, H, np), keys past n
// zero, keys permuted within each group of 8.  A block is 32 keys x 32
// columns of one (b, h), through shared memory.
__global__ void split_vt(const float* __restrict__ v, long long sb, long long sn, long long sh,
                         float* __restrict__ hi, float* __restrict__ lo, int n, int np, int heads,
                         int d, int bhs) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int key = (tx & ~7) | ((tx & 7) < 4 ? 2 * (tx & 7) : 2 * (tx & 7) - 7);  // at position tx
  for (int bh = blockIdx.z; bh < bhs; bh += gridDim.z) {
    const int b = bh / heads, h = bh % heads;
    __syncthreads();
    for (int i = ty; i < 32; i += 8)
      tile[i][tx] = k0 + i < n ? v[b * sb + (k0 + i) * sn + h * sh + d0 + tx] : 0.f;
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      float xh, xl;
      split_tf32(tile[key][i], xh, xl);
      const long long off = (((long long)b * d + d0 + i) * heads + h) * np + k0 + tx;
      hi[off] = xh;
      lo[off] = xl;
    }
  }
}

template <typename E, bool QRES>
void* kernel_of(bool fast) {
  return fast ? reinterpret_cast<void*>(flash_wide<E, true, QRES>)
              : reinterpret_cast<void*>(flash_wide<E, false, QRES>);
}

template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
        int head_dim, const long long* st, float scale, int fast, float* scratch, int q_resident,
        cudaStream_t stream) {
  using T = Tr<E>;
  using R = Ring<E, true>;
  using S = Ring<E, false>;
  if (batch < 0 || n < 0 || heads < 0 || head_dim < 64 * NP || head_dim % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)batch * n * heads == 0) return 0;
  const int sp = head_dim / T::CP;
  // bf16 keeps Q resident where it fits beside kMinStages stages
  // (q_resident >= 0 forces the choice where Q fits beside NP stages); fp32
  // streams it
  const int room = kSmemLimit - 1024 - kBarBytes;
  const int res_stages = (room - sp * R::Q_PANEL) / R::SB;
  bool qres = false;
  void* kern = kernel_of<E, false>(fast);
  if constexpr (sizeof(E) == 2) {
    qres = q_resident < 0 ? res_stages >= kMinStages : (q_resident && res_stages >= NP);
    if (qres) kern = kernel_of<E, true>(fast);
  }
  Params p;
  p.o = o;
  p.n = n;
  p.heads = heads;
  p.sp = sp;
  p.op = head_dim / 64;
  p.slices = (p.op + NP - 1) / NP;
  p.stages = std::min(kMaxStages, qres ? res_stages : room / S::SB);
  p.gs = std::max(1, std::min(sp, p.stages / 2));  // the other half of the ring loads meanwhile
  const int smem =
      1024 + (qres ? sp * R::Q_PANEL : 0) + p.stages * (qres ? R::SB : S::SB) + kBarBytes;
  p.bh = batch * heads;
  for (int i = 0; i < 3; ++i) p.os[i] = st[9 + i];
  // a runtime call before the maps: it makes the context current (make_map)
  const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tq_lo, tk, tk_lo, tv, tv_lo;
  if constexpr (sizeof(E) == 2) {
    if (!make_map(&tq, q, batch, n, heads, st[0], st[1], st[2], 64, head_dim) ||
        !make_map(&tk, k, batch, n, heads, st[3], st[4], st[5], T::KT, head_dim) ||
        !make_map(&tv, v, batch, n, heads, st[6], st[7], st[8], T::KT, head_dim))
      return static_cast<int>(cudaErrorInvalidValue);
    tq_lo = tq;
    tk_lo = tk;
    tv_lo = tv;
    p.scale_log2 = scale * 1.4426950408889634f;
  } else {
    // the pre-pass: q * scale * log2(e), k and v^T split into hi and lo
    constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const long long rows = (long long)batch * n * heads * head_dim;
    const int np = (n + T::KT - 1) / T::KT * T::KT;
    const long long vts = (long long)batch * head_dim * heads * np;
    float *qh = scratch, *ql = qh + rows, *kh = ql + rows, *kl = kh + rows;
    float *vh = kl + rows, *vl = vh + vts;
    const long long total = rows / 4;
    const int blocks = static_cast<int>(std::min(total / 256 + 1, 132LL * 16));
    split_rows<<<blocks, 256, 0, stream>>>(static_cast<const float*>(q), st[0], st[1], st[2],
                                           scale * 1.4426950408889634f, qh, ql, n, heads,
                                           head_dim / 4, total);
    split_rows<<<blocks, 256, 0, stream>>>(static_cast<const float*>(k), st[3], st[4], st[5], 1.f,
                                           kh, kl, n, heads, head_dim / 4, total);
    const dim3 tgrid(np / 32, head_dim / 32, std::min(p.bh, 65535));
    split_vt<<<tgrid, dim3(32, 8), 0, stream>>>(static_cast<const float*>(v), st[6], st[7], st[8],
                                                vh, vl, n, np, heads, head_dim, p.bh);
    const cudaError_t pre = cudaGetLastError();
    if (pre != cudaSuccess) return static_cast<int>(pre);
    const long long dn = (long long)n * heads * head_dim, dh = (long long)heads * head_dim;
    const long long tb = (long long)head_dim * heads * np, th = (long long)heads * np;
    if (!make_map(&tq, qh, batch, n, heads, dn, dh, head_dim, 64, head_dim, F32) ||
        !make_map(&tq_lo, ql, batch, n, heads, dn, dh, head_dim, 64, head_dim, F32) ||
        !make_map(&tk, kh, batch, n, heads, dn, dh, head_dim, T::KT, head_dim, F32) ||
        !make_map(&tk_lo, kl, batch, n, heads, dn, dh, head_dim, T::KT, head_dim, F32) ||
        // v^T as a (B, D, H, np) view: rows are columns of O, boxes of 32 keys
        !make_map(&tv, vh, batch, head_dim, heads, tb, th, np, 64, np, F32) ||
        !make_map(&tv_lo, vl, batch, head_dim, heads, tb, th, np, 64, np, F32))
      return static_cast<int>(cudaErrorInvalidValue);
    p.scale_log2 = 1.f;
  }
  const long long gx = (long long)((n + 63) / 64) * p.slices;
  if (gx > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int gy = p.bh < 65535 ? p.bh : 65535;
  const dim3 grid(static_cast<unsigned>(gx), gy, (p.bh + gy - 1) / gy);
  void* args[] = {&tq, &tq_lo, &tk, &tk_lo, &tv, &tv_lo, &p};
  const cudaError_t err = cudaLaunchKernel(kern, grid, dim3(256), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, N, H, D) views with unit stride in D and the given (b, n,
// h) element strides (TMA: 16-byte aligned bases, strides multiples of 16
// bytes); o contiguous or likewise (4-byte aligned pairs).  D a multiple
// of 64, at least 320 (the wrapper sends D = 64 (mod 128) here).  fast != 0
// selects the no-max variant.  q_resident < 0 keeps Q in shared memory
// where it fits beside kMinStages ring stages; 0 / 1 force the choice
// (where Q fits).  Returns cudaErrorInvalidValue for what TMA cannot read.
extern "C" int vda_flash_attention_wide(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, int q_resident,
    void* stream) {
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  return run<bf16>(q, k, v, o, batch, n, heads, head_dim, st, scale, fast, nullptr, q_resident,
                   static_cast<cudaStream_t>(stream));
}

// The same on fp32 operands (Q always streamed); scratch holds
// vda_flash_attention_wide_f32_scratch floats (the pre-pass's hi and lo
// copies), 16-byte aligned.
extern "C" int vda_flash_attention_wide_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, void* scratch,
    void* stream) {
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  if (reinterpret_cast<uintptr_t>(scratch) % 16) return static_cast<int>(cudaErrorInvalidValue);
  return run<float>(q, k, v, o, batch, n, heads, head_dim, st, scale, fast,
                    static_cast<float*>(scratch), -1, static_cast<cudaStream_t>(stream));
}

// Floats of the fp32 pre-pass's scratch: q and k hi and lo (4 B N H D), v^T
// hi and lo (2 B D H Np, Np = N padded to 32 keys).
extern "C" long long vda_flash_attention_wide_f32_scratch(int batch, int n, int heads,
                                                          int head_dim) {
  const long long np = (n + 31) / 32 * 32;
  return 4LL * batch * n * heads * head_dim + 2LL * batch * head_dim * heads * np;
}
