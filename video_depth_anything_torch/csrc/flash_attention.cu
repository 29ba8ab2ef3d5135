// Kernel A: flash-attention forward for the ViT's spatial attention.
//
// Replaces the TPU kernels video_depth_anything_tpu/ops/pallas_attention.py:
// _flash_kernel_native (via flash_attention_native, padded N <= 2048),
// _flash_kernel (via _flash_forward / spatial_flash_attention, the 512-key
// online-softmax path for longer rows, e.g. 518x924 frames with N = 2443),
// _flash_kernel_fast (the no-max variant of the latter) and
// _flash_kernel_single (the whole-row kernel for odd head counts and
// D = 192, exact or fast).  Every variant loops over key tiles with an
// online fp32 softmax, so any N works, and reads q, k and v through
// generic (batch, token, head) strides straight from the (B, N, 3*H*D) qkv
// projection -- no transposes and no pad copies, and any head count.
//
// Bound on the H100: compute.  At 518x924 with B*T = 32 a call does
// 4*N^2*D*H*B = 2.9e11 FLOP (0.30 ms at 989 TFLOP/s) and moves ~240 MB
// (0.07 ms).  Both products run on the tensor cores with fp32 accumulate,
// S and P stay in registers (never in memory), and the hardware exp2 takes
// scale*log2(e) folded into the scores (at D = 64 into its FMA).  The
// TPU's exp2 polynomial and ones-column row sum were VPU workarounds and
// are not carried over.
//
// D = 64 (every shipped encoder): flash_fwd_hopper<FAST>, for sm_90a.
//   * A CTA is one (b, h) and 128 queries in three warpgroups.  Warpgroup
//     0 is the producer: one thread issues TMA loads (hopper.cuh) and the
//     group gives its registers away (setmaxnreg 24); warpgroups 1 and 2
//     are the consumers, 64 query rows each, with 240 registers.
//   * Shared memory: the Q tile (128 x 64 bf16, 16 KB) is loaded once; K
//     and V tiles of 128 keys (16 KB each) run through a ring of kStages
//     stages with full and empty mbarriers: 112 KB at three stages.  TMA
//     reads each operand through a 4-D map (D, H, N, B) of its strided
//     view, so the fused qkv projection needs no copy; rows past N arrive
//     zero-filled, in the 128-byte swizzle the wgmma descriptors expect.
//   * S = Q K^T: wgmma m64n128k16, 4 steps over D, both operands K-major
//     in shared memory.  The online softmax runs on the accumulator in
//     registers, in the mma.m16n8k16 C layout (row max and sum over the
//     quad by shuffles).  O += P V: wgmma m64n64k16, P packed to bf16 A
//     fragments in registers, V MN-major in shared memory (transpose bit).
//     The K/V stage goes back to the producer once wgmma.wait_group shows
//     that the P V product has read it.
//   * Only the last key tile is masked, in a branch uniform across the
//     CTA: a zero-filled pad key scores 0, not -inf.
//   * Left for later: overlapping one tile's softmax with the next tile's
//     S product, and ping-pong scheduling of the two consumers.  The two
//     consumers run unsynchronised, so one's softmax overlaps the other's
//     products.
// D = 192 (the JAX gate's domain up to 256; no shipped encoder, 0
// launches): flash_fwd_hopper192<FAST>, D = 64's design over rows of three
// 128-byte swizzle panels.
//   * The same three warpgroups (producer, two consumers of 64 query rows,
//     setmaxnreg 24/240) and 128 queries a CTA.  Q is 128 x 192 bf16 (48
//     KB), loaded once as three TMA boxes of 64 columns through a 4-D map
//     (192, H, N, B).  K and V come in 64-key tiles, 24 KB each (three
//     panels), through a ring of kStages192 = 3 stages: 192 KB in all
//     (128-key tiles would need 240 KB at two stages, over the 227 KB a
//     block may have).
//   * S = Q K^T: wgmma m64n64k16 over 12 k16 steps, the descriptors moving
//     to the next panel every 4.  O += P V: for each 16-key step, three
//     wgmma m64n64k16 with P from registers and V MN-major, one per
//     64-column panel of O (96 fp32 accumulators a thread).
//   * As at D = 64: only the ragged last tile is masked (-inf), the stage
//     goes back once the P V products that read it are waited for, and the
//     two consumers overlap each other's softmax and products.
//   * Bound: 4 * N^2 * 192 * H * B FLOP; the softmax per FLOP is a third
//     of D = 64's.
// The head_dim dispatch at the bottom is a domain split: each width has
// one kernel.
//
// FAST is the TPU kernels' no-max softmax (pallas_attention.py:123-156,
// :183-192, :233-234): the running max stays 0 and p = exp2(s * scale *
// log2(e)) with no rescale.  The quotient is the exact softmax's while the
// scaled logits stay inside fp32's exp2 domain (about +-88 natural units):
// above that the hardware exp2f overflows to inf and the row turns to nan,
// where the TPU's polynomial clamps.  That is the JAX contract of the
// ':fast' suffix; nothing here switches variants.
// Pad keys of the ragged last tile are masked to -inf (p = 0 in both
// variants); pad query rows are computed on zeros and never stored.
//
// For training, the kernel also writes each real query row's log-sum-exp
// in the exp2 domain, lse = m + log2(l) over the scaled scores
// s * scale * log2(e) (m = 0 under FAST), fp32, laid out (B, H, N); the
// backward kernels (flash_attention_bwd.cu) recompute
// P = exp2(s * scale * log2(e) - lse) from it, which is the normalised P
// of either variant.  Inference passes a null pointer and writes nothing.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- D = 64: the Hopper kernel ----
constexpr int kRows = 128;  // queries per CTA, keys per tile
constexpr int kStages = 3;  // K/V ring: faster than 2 or 4 stages on the H100
constexpr int kTileBytes = kRows * 64 * 2;

struct FwdSmem {
  bf16 q[kRows * 64];
  bf16 k[kStages][kRows * 64];
  bf16 v[kStages][kRows * 64];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};
constexpr int kFwdSmemBytes = sizeof(FwdSmem) + 1024;

template <bool FAST>
__global__ void __launch_bounds__(384, 1) flash_fwd_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n, int heads,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, float* __restrict__ lse) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = aligned_smem<FwdSmem>(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (n + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kTileBytes);
      tma_load_4d(sm.q, &tq, &sm.q_full, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&sm.empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.k_full[s], kTileBytes);
        tma_load_4d(sm.k[s], &tk, &sm.k_full[s], 0, h, j * kRows, b);
        mbar_arrive_expect_tx(&sm.v_full[s], kTileBytes);
        tma_load_4d(sm.v[s], &tv, &sm.v_full[s], 0, h, j * kRows, b);
      }
    }
  } else {  // consumers: query rows (wg - 1) * 64 .. + 64 of the CTA's 128
    setmaxnreg_inc<240>();
    const int warp = tid >> 5, lane = tid & 31, c2 = (lane & 3) * 2;
    const uint64_t dq = desc_sw128(sm.q + (wg - 1) * 64 * 64);
    // Under FAST the running max stays 0: no max pass and no rescale.
    float m_i[2] = {FAST ? 0.f : -INFINITY, FAST ? 0.f : -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(&sm.q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      mbar_wait(&sm.k_full[s], ph);
      float sc[64];
      const uint64_t dk = desc_sw128(sm.k[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(sc, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask the pad keys of the ragged last tile; the online softmax works
      // on the raw scores and folds scale * log2(e) into the exp2's FMA
      const int valid = n - j * kRows;
      if (valid < kRows) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if ((i >> 2) * 8 + c2 + (i & 1) >= valid) sc[i] = -INFINITY;
      }
      if constexpr (!FAST) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float m_new = fmaxf(m_i[rr], mx[rr] * scale_log2);
          const float alpha = exp2_approx(m_i[rr] - m_new);
          m_i[rr] = m_new;
          l_i[rr] *= alpha;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            acc[4 * t + 2 * rr] *= alpha;
            acc[4 * t + 2 * rr + 1] *= alpha;
          }
        }
      }
      uint32_t pa[8][4];  // P as bf16 A fragments, 16 keys per step
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -m_i[(i >> 1) & 1]));
        l_i[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      mbar_wait(&sm.v_full[s], ph);
      const uint64_t dv = desc_sw128(sm.v[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64_tb(acc, pa[kk], dv + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&sm.empty[s]);
    }

    float inv[2];
    const int r0 = q0 + (wg - 1) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_i[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[rr] = 1.f / l;
      const int row = r0 + rr * 8;
      if (lse != nullptr && (lane & 3) == 0 && row < n)
        lse[(long long)blockIdx.y * n + row] = m_i[rr] + log2f(l);
    }
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * o_sn + t * 8 + c2) =
            pack_bf16x2(acc[4 * t] * inv[0], acc[4 * t + 1] * inv[0]);
      if (r0 + 8 < n)
        *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * o_sn + t * 8 + c2) =
            pack_bf16x2(acc[4 * t + 2] * inv[1], acc[4 * t + 3] * inv[1]);
    }
  }
}

template <bool FAST>
int launch_hopper(const void* q, const void* k, const void* v, void* o, int batch, int n,
                  int heads, const long long* st, float scale, void* lse, cudaStream_t stream) {
  // a runtime call before the maps: it makes the context current (make_map)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_hopper<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, n, heads, st[0], st[1], st[2], kRows) ||
      !make_map(&tk, k, batch, n, heads, st[3], st[4], st[5], kRows) ||
      !make_map(&tv, v, batch, n, heads, st[6], st[7], st[8], kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kRows - 1) / kRows, batch * heads);
  flash_fwd_hopper<FAST><<<grid, 384, kFwdSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), n, heads, st[9], st[10], st[11],
      scale * 1.4426950408889634f, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

// ---- D = 192: the Hopper kernel ----
constexpr int kPanels = 3;                   // a D = 192 row: three 128-byte swizzle panels
constexpr int kKeys192 = 64;                 // keys per tile
constexpr int kStages192 = 3;                // K/V ring
constexpr int kPanelBytes = kKeys192 * 64 * 2;  // one 64-key panel, 8 KB

struct Fwd192Smem {
  bf16 q[kPanels][kRows * 64];                      // 48 KB
  bf16 k[kStages192][kPanels][kKeys192 * 64];       // 24 KB a stage
  bf16 v[kStages192][kPanels][kKeys192 * 64];       // 24 KB a stage
  uint64_t q_full, k_full[kStages192], v_full[kStages192], empty[kStages192];
};
constexpr int kFwd192SmemBytes = sizeof(Fwd192Smem) + 1024;

template <bool FAST>
__global__ void __launch_bounds__(384, 1) flash_fwd_hopper192(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n, int heads,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, float* __restrict__ lse) {
  extern __shared__ unsigned char smem_raw[];
  Fwd192Smem& sm = aligned_smem<Fwd192Smem>(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (n + kKeys192 - 1) / kKeys192;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages192; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: Q once, then K and V tiles, each as three panels
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kPanels * kTileBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) tma_load_4d(sm.q[p], &tq, &sm.q_full, 64 * p, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages192;
        if (j >= kStages192) mbar_wait(&sm.empty[s], (j / kStages192 - 1) & 1);
        mbar_arrive_expect_tx(&sm.k_full[s], kPanels * kPanelBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(sm.k[s][p], &tk, &sm.k_full[s], 64 * p, h, j * kKeys192, b);
        mbar_arrive_expect_tx(&sm.v_full[s], kPanels * kPanelBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(sm.v[s][p], &tv, &sm.v_full[s], 64 * p, h, j * kKeys192, b);
      }
    }
  } else {  // consumers: query rows (wg - 1) * 64 .. + 64 of the CTA's 128
    setmaxnreg_inc<240>();
    const int warp = tid >> 5, lane = tid & 31, c2 = (lane & 3) * 2;
    uint64_t dq[kPanels];
#pragma unroll
    for (int p = 0; p < kPanels; ++p) dq[p] = desc_sw128(sm.q[p] + (wg - 1) * 64 * 64);
    // Under FAST the running max stays 0: no max pass and no rescale.
    float m_i[2] = {FAST ? 0.f : -INFINITY, FAST ? 0.f : -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float acc[kPanels][32];  // O's three 64-column panels
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    mbar_wait(&sm.q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages192;
      const uint32_t ph = (j / kStages192) & 1;
      mbar_wait(&sm.k_full[s], ph);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kPanels; ++kk)  // 12 k16 steps, 4 a panel
        wgmma_ss_n64(sc, dq[kk / 4] + 2 * (kk % 4), desc_sw128(sm.k[s][kk / 4]) + 2 * (kk % 4), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask the pad keys of the ragged last tile; the online softmax works
      // on the raw scores and folds scale * log2(e) into the exp2's FMA
      const int valid = n - j * kKeys192;
      if (valid < kKeys192) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((i >> 2) * 8 + c2 + (i & 1) >= valid) sc[i] = -INFINITY;
      }
      if constexpr (!FAST) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float m_new = fmaxf(m_i[rr], mx[rr] * scale_log2);
          const float alpha = exp2_approx(m_i[rr] - m_new);
          m_i[rr] = m_new;
          l_i[rr] *= alpha;
#pragma unroll
          for (int p = 0; p < kPanels; ++p)
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              acc[p][4 * t + 2 * rr] *= alpha;
              acc[p][4 * t + 2 * rr + 1] *= alpha;
            }
        }
      }
      uint32_t pa[4][4];  // P as bf16 A fragments, 16 keys per step
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -m_i[(i >> 1) & 1]));
        l_i[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      mbar_wait(&sm.v_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          wgmma_rs_n64_tb(acc[p], pa[kk], desc_sw128(sm.v[s][p]) + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
      if (tid == 0) mbar_arrive(&sm.empty[s]);
    }

    float inv[2];
    const int r0 = q0 + (wg - 1) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_i[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[rr] = 1.f / l;
      const int row = r0 + rr * 8;
      if (lse != nullptr && (lane & 3) == 0 && row < n)
        lse[(long long)blockIdx.y * n + row] = m_i[rr] + log2f(l);
    }
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = 64 * p + t * 8 + c2;
        if (r0 < n)
          *reinterpret_cast<uint32_t*>(ob + (long long)r0 * o_sn + col) =
              pack_bf16x2(acc[p][4 * t] * inv[0], acc[p][4 * t + 1] * inv[0]);
        if (r0 + 8 < n)
          *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * o_sn + col) =
              pack_bf16x2(acc[p][4 * t + 2] * inv[1], acc[p][4 * t + 3] * inv[1]);
      }
  }
}

template <bool FAST>
int launch_hopper192(const void* q, const void* k, const void* v, void* o, int batch, int n,
                     int heads, const long long* st, float scale, void* lse, cudaStream_t stream) {
  // a runtime call before the maps: it makes the context current (make_map)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_hopper192<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwd192SmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, n, heads, st[0], st[1], st[2], kRows, 192) ||
      !make_map(&tk, k, batch, n, heads, st[3], st[4], st[5], kKeys192, 192) ||
      !make_map(&tv, v, batch, n, heads, st[6], st[7], st[8], kKeys192, 192))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kRows - 1) / kRows, batch * heads);
  flash_fwd_hopper192<FAST><<<grid, 384, kFwd192SmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), n, heads, st[9], st[10], st[11],
      scale * 1.4426950408889634f, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head_dim is 64 or 192, one Hopper kernel each (q, k and v must be
// TMA-describable: 16-byte aligned bases, strides multiples of 8
// elements); anything else, or a view no tensor map can describe, returns
// cudaErrorInvalidValue.  fast != 0 selects the no-max variant.
extern "C" int vda_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, void* lse,
    void* stream) {
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return fast ? launch_hopper<true>(q, k, v, o, batch, n, heads, st, scale, lse, s)
                : launch_hopper<false>(q, k, v, o, batch, n, heads, st, scale, lse, s);
  if (head_dim == 192)
    return fast ? launch_hopper192<true>(q, k, v, o, batch, n, heads, st, scale, lse, s)
                : launch_hopper192<false>(q, k, v, o, batch, n, heads, st, scale, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
