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
// launches): the mma.sync tiling, flash_fwd_kernel<192, FAST>: 64 queries
// per CTA (4 warps x 16 rows), 64 keys per step, synchronous 16-byte loads
// into 76.8 KB of dynamic shared memory, mma.sync m16n8k16.  The head_dim
// dispatch at the bottom is a domain split: each width has one kernel.
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

// ---- D = 192: the mma.sync tiling ----
constexpr int BM = 64;
constexpr int BN = 64;

template <int D>
__host__ __device__ constexpr int smem_elems() { return (BM + 2 * BN) * tile_lds<D>(); }

template <int D, bool FAST>
__global__ void __launch_bounds__(128) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, float* __restrict__ lse) {
  constexpr int LDS = tile_lds<D>();
  constexpr int KD = D / 16;         // 16-wide steps over D in Q K^T
  constexpr int NT = D / 8;          // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_dynamic[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_dynamic);
  bf16* sK = sQ + BM * LDS;
  bf16* sV = sK + BN * LDS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;

  load_tile<D>(sQ, qb, q_sn, q0, n, tid);
  __syncthreads();

  const bf16* q_row = &sQ[(warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8];

  // Under FAST the running max stays 0: no max pass and no rescale.
  float m_i[2] = {FAST ? 0.f : -INFINITY, FAST ? 0.f : -INFINITY};
  float l_i[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const int mi = lane >> 3, r8 = lane & 7;
  const int n_tiles = (n + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, k_sn, k0, n, tid);
    load_tile<D>(sV, vb, v_sn, k0, n, tid);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a[0], a[1], a[2], a[3], q_row + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    &sK[(np * 16 + r8 + (mi >> 1) * 8) * LDS + kk * 16 + (mi & 1) * 8]);
        mma_bf16_16816(s[2 * np], a, b0, b1);
        mma_bf16_16816(s[2 * np + 1], a, b2, b3);
      }
    }

    // scale into the exp2 domain, mask pad keys, online softmax update
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + t * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[t][e] * scale_log2;
        if (col >= n) x = -INFINITY;
        s[t][e] = x;
        if constexpr (!FAST) mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    if constexpr (!FAST) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m_i[rr], mx[rr]);
        const float alpha = exp2f(m_i[rr] - m_new);
        m_i[rr] = m_new;
        l_i[rr] *= alpha;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          acc[t][2 * rr] *= alpha;
          acc[t][2 * rr + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[t][e] - m_i[e >> 1]);
        s[t][e] = p;
        l_i[e >> 1] += p;
      }

    // O += P V: P goes from the accumulator layout straight into A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          &sV[(kk * 16 + r8 + (mi & 1) * 8) * LDS + (dp * 2 + (mi >> 1)) * 8]);
        mma_bf16_16816(acc[2 * dp], a, b0, b1);
        mma_bf16_16816(acc[2 * dp + 1], a, b2, b3);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_i[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rr] = 1.f / l;
    const int row = q0 + warp * 16 + (lane >> 2) + rr * 8;
    if (lse != nullptr && (lane & 3) == 0 && row < n)
      lse[(long long)blockIdx.y * n + row] = m_i[rr] + log2f(l);
  }
  const int r0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = t * 8 + (lane & 3) * 2;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * o_sn + col) =
          pack_bf16x2(acc[t][0] * inv[0], acc[t][1] * inv[0]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * o_sn + col) =
          pack_bf16x2(acc[t][2] * inv[1], acc[t][3] * inv[1]);
  }
}

template <int D, bool FAST>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
           const long long* st, float scale, void* lse, cudaStream_t stream) {
  constexpr int smem = smem_elems<D>() * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n + BM - 1) / BM, batch * heads);
  flash_fwd_kernel<D, FAST><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head_dim is 64 (the Hopper kernel; q, k and v must be TMA-describable:
// 16-byte aligned bases, strides multiples of 8 elements) or 192 (the
// mma.sync tiling); anything else, or a view no tensor map can describe,
// returns cudaErrorInvalidValue.  fast != 0 selects the no-max variant.
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
    return fast ? launch<192, true>(q, k, v, o, batch, n, heads, st, scale, lse, s)
                : launch<192, false>(q, k, v, o, batch, n, heads, st, scale, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
