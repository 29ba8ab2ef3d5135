// Kernel A's backward: flash-attention gradients for the ViT's spatial
// attention, the VJP that training with an unfrozen encoder runs in every
// block.
//
// Replaces the TPU kernel video_depth_anything_tpu/ops/pallas_attention.py
// _flash_kernel_native_bwd (launched by _native_bwd_pallas).  Per (batch,
// head) it computes, with P recomputed from the forward's log-sum-exp:
//
//   P  = exp2(S * scale * log2(e) - lse),  S = Q K^T
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
//
// The TPU kernel takes Delta = rowsum(dP * P) from the whole score row it
// holds in VMEM.  Here no CTA holds a whole row, so Delta = rowsum(dO * O)
// comes from a pre-pass over the forward's output: the same sum, since
// rowsum_j(dP_ij P_ij) = sum_d dO_id sum_j P_ij V_jd = sum_d dO_id O_id,
// up to the rounding of O to bf16.
//
// The rounding points are the TPU kernel's: P is normalised in fp32 and
// rounded to bf16 before P^T dO; dS is rounded to bf16 before both
// products; dQ and dK are scaled by `scale` in fp32 after their products.
// dK uses the unscaled bf16 Q (the TPU kernel uses its pre-scaled Q and
// divides by log2(e): one bf16 rounding apart).
//
// Bound on the H100: compute.  Five N x N x D products per (batch, head),
// 10 * N^2 * D * H * B FLOP: at 518x518 with B*T = 32 and 6 heads 1.5e11
// FLOP (0.16 ms at 989 TFLOP/s) against ~50 MB moved (0.015 ms).  Every
// product runs on wgmma (bf16, fp32 accumulate) fed by TMA (hopper.cuh);
// S, P, dP and dS stay in registers; no two CTAs write the same output and
// nothing uses atomics, so the result is deterministic.  Three launches:
//   * flash_bwd_prep_kernel: Delta per (b, h, query row), 8 lanes a row,
//     written beside a copy of lse into a (2, B*H, Np) fp32 buffer padded to
//     Np = 128 * ceil(N / 128) rows, pads lse = +inf and Delta = 0: the pads
//     give P = exp2(0 - inf) = 0 to the zero-filled pad queries, so the
//     dK/dV kernel masks nothing, and each 64-row slice is one aligned
//     256-byte bulk copy.
//   * flash_bwd_dkdv_kernel: a CTA per (b, h, 128 keys) in three
//     warpgroups: a TMA producer (setmaxnreg 24) and two consumers of 64
//     keys (240 registers).  K and V stay in shared memory as the A
//     operands of S^T = K Q^T and dP^T = V dO^T; a ring of kStages stages
//     brings 64-query tiles of Q and dO (TMA) and their lse and Delta
//     slices (bulk copies).  Per tile: S^T and dP^T (m64n64k16, both
//     operands K-major), P^T in registers, dV += P^T dO and, after
//     dS^T = P^T (dP^T - Delta), dK += dS^T Q (register A, B MN-major).
//   * flash_bwd_dq_kernel: a CTA per (b, h, 128 queries), the same three
//     warpgroups; Q and dO stay in shared memory, the ring brings 64-key
//     tiles of K and V.  Per tile: S and dP, then dQ += dS K.  The pad keys
//     of the ragged last key tile are masked there (a zero key scores 0).
// Each kernel recomputes S and the dK/dV and dQ kernels each form dP, so a
// step does 7 N x N x D products where the math needs 5.
//
// Pad keys are never stored by the dK/dV kernel, pad query rows never by
// the dQ kernel.  q, k and v may be strided (batch, token, head) views of
// the fused qkv projection (TMA-describable: 16-byte aligned bases and
// strides); o, dO, dq, dk and dv are contiguous (B, N, H, D); lse is fp32
// (B, H, N).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 64;
constexpr int kRes = 128;   // rows of the tile a CTA keeps (keys or queries)
constexpr int kStep = 64;   // rows of a streamed tile
constexpr int kStages = 3;  // faster than 2 stages on the H100
constexpr int kResBytes = kRes * D * 2;
constexpr int kStepBytes = kStep * D * 2;

// Delta[b, h, i] = sum_d o[b, i, h, d] * g[b, i, h, d] (fp32 products of
// bf16) and a copy of lse, for rows i < np, into aux (2, B*H, np).
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ aux, int bh_rows, int n, int np, int heads) {
  const int r = blockIdx.x * 32 + (threadIdx.x >> 3);  // (b*H + h) * np + i
  const int part = threadIdx.x & 7;
  const int bh = r / np, i = r % np;
  const bool real = r < bh_rows && i < n;
  float s = 0.f;
  if (real) {
    const long long row = ((long long)(bh / heads) * n + i) * heads + bh % heads;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + row * D + part * 8);
    const bf162* o2 = reinterpret_cast<const bf162*>(&ov);
    const bf162* g2 = reinterpret_cast<const bf162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]);
      const float2 b = __bfloat1622float2(g2[e]);
      s += a.x * b.x + a.y * b.y;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (r < bh_rows && part == 0) {
    aux[r] = real ? lse[(long long)bh * n + i] : INFINITY;
    aux[bh_rows + r] = s;
  }
}

// P or P^T (x = scores) to bf16 A fragments: the accumulator's n8 blocks
// 2kk and 2kk + 1 are the 16 columns of step kk.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Store a warpgroup's 64 rows (row0 + 16 * warp + ..) of a [64 x 64] fp32
// accumulator, times `mul`, as bf16 into a row-major matrix (row stride
// `ld`), rows < n only.
__device__ __forceinline__ void store_rows(bf16* out, long long ld, const float (&x)[32],
                                           int row0, int n, float mul, int tid) {
  const int r0 = row0 + (tid >> 5) * 16 + ((tid & 31) >> 2), c2 = (tid & 3) * 2;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * ld + t * 8 + c2) =
          pack_bf16x2(x[4 * t] * mul, x[4 * t + 1] * mul);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + 8) * ld + t * 8 + c2) =
          pack_bf16x2(x[4 * t + 2] * mul, x[4 * t + 3] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

struct DkdvSmem {
  bf16 k[kRes * D];
  bf16 v[kRes * D];
  bf16 q[kStages][kStep * D];
  bf16 g[kStages][kStep * D];
  float lse[kStages][kStep];
  float delta[kStages][kStep];
  uint64_t kv_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(384, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
    const float* __restrict__ aux, bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int np,
    int heads, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem& sm = aligned_smem<DkdvSmem>(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kRes;
  const int n_tiles = (n + kStep - 1) / kStep;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      const float* lb = aux + (long long)blockIdx.y * np;
      const float* db = lb + (long long)gridDim.y * np;
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kResBytes);
      tma_load_4d(sm.k, &tk, &sm.kv_full, 0, h, k0, b);
      tma_load_4d(sm.v, &tv, &sm.kv_full, 0, h, k0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * kStepBytes + 2 * kStep * 4);
        tma_load_4d(sm.q[s], &tq, &sm.full[s], 0, h, i * kStep, b);
        tma_load_4d(sm.g[s], &tg, &sm.full[s], 0, h, i * kStep, b);
        bulk_load(sm.lse[s], lb + i * kStep, kStep * 4, &sm.full[s]);
        bulk_load(sm.delta[s], db + i * kStep, kStep * 4, &sm.full[s]);
      }
    }
  } else {  // consumers: keys k0 + (wg - 1) * 64 .. + 64
    setmaxnreg_inc<240>();
    const int c2 = (tid & 3) * 2;
    const uint64_t dk_a = desc_sw128(sm.k + (wg - 1) * 64 * D);
    const uint64_t dv_a = desc_sw128(sm.v + (wg - 1) * 64 * D);
    float dka[32], dva[32];
    zero(dka);
    zero(dva);
    mbar_wait(&sm.kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      const uint64_t dq_b = desc_sw128(sm.q[s]), dg_b = desc_sw128(sm.g[s]);
      float pt[32], dpt[32];  // S^T then P^T; dP^T then dS^T (keys x queries)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(pt, dk_a + 2 * kk, dq_b + 2 * kk, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(dpt, dv_a + 2 * kk, dg_b + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(pt);
      // P^T, normalised; pad queries get lse = +inf, so P = 0
#pragma unroll
      for (int e = 0; e < 32; ++e)
        pt[e] = exp2_approx(fmaf(pt[e], scale_log2, -sm.lse[s][(e >> 2) * 8 + c2 + (e & 1)]));
      uint32_t a[4][4], a2[4][4];
      to_a_frags(a, pt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
        wgmma_rs_n64_tb(dva, a[kk], dg_b + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dpt);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dpt[e] = pt[e] * (dpt[e] - sm.delta[s][(e >> 2) * 8 + c2 + (e & 1)]);
      to_a_frags(a2, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
        wgmma_rs_n64_tb(dka, a2[kk], dq_b + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      if (tid == 0) mbar_arrive(&sm.empty[s]);
    }
    const long long hd = (long long)heads * D;
    const long long out_off = (long long)b * n * hd + h * D;
    const int row0 = k0 + (wg - 1) * 64;
    store_rows(dk + out_off, hd, dka, row0, n, scale, tid);
    store_rows(dv + out_off, hd, dva, row0, n, 1.f, tid);
  }
}

struct DqSmem {
  bf16 q[kRes * D];
  bf16 g[kRes * D];
  bf16 k[kStages][kStep * D];
  bf16 v[kStages][kStep * D];
  uint64_t qg_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(384, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
    const float* __restrict__ aux, bf16* __restrict__ dq, int n, int np, int heads,
    float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kRes;
  const int n_tiles = (n + kStep - 1) / kStep;
  if (threadIdx.x == 0) {
    mbar_init(&sm.qg_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.qg_full, 2 * kResBytes);
      tma_load_4d(sm.q, &tq, &sm.qg_full, 0, h, q0, b);
      tma_load_4d(sm.g, &tg, &sm.qg_full, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&sm.empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * kStepBytes);
        tma_load_4d(sm.k[s], &tk, &sm.full[s], 0, h, j * kStep, b);
        tma_load_4d(sm.v[s], &tv, &sm.full[s], 0, h, j * kStep, b);
      }
    }
  } else {  // consumers: queries q0 + (wg - 1) * 64 .. + 64
    setmaxnreg_inc<240>();
    const int c2 = (tid & 3) * 2;
    const int row0 = q0 + (wg - 1) * 64;
    const uint64_t dq_a = desc_sw128(sm.q + (wg - 1) * 64 * D);
    const uint64_t dg_a = desc_sw128(sm.g + (wg - 1) * 64 * D);
    // this thread's rows' lse and Delta (pad rows: lse = +inf, Delta = 0)
    float lrow[2], drow[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long at =
          (long long)blockIdx.y * np + row0 + (tid >> 5) * 16 + ((tid & 31) >> 2) + rr * 8;
      lrow[rr] = aux[at];
      drow[rr] = aux[(long long)gridDim.y * np + at];
    }
    float dqa[32];
    zero(dqa);
    mbar_wait(&sm.qg_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&sm.full[s], (j / kStages) & 1);
      const uint64_t dk_b = desc_sw128(sm.k[s]), dv_b = desc_sw128(sm.v[s]);
      float p[32], dp[32];  // S then P; dP then dS (queries x keys)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(p, dq_a + 2 * kk, dk_b + 2 * kk, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(dp, dg_a + 2 * kk, dv_b + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(p);
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = exp2_approx(fmaf(p[e], scale_log2, -lrow[(e >> 1) & 1]));
      const int valid = n - j * kStep;
      if (valid < kStep) {  // the ragged last key tile: zero-filled keys
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if ((e >> 2) * 8 + c2 + (e & 1) >= valid) p[e] = 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] = p[e] * (dp[e] - drow[(e >> 1) & 1]);
      uint32_t a[4][4];
      to_a_frags(a, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dQ += dS K
        wgmma_rs_n64_tb(dqa, a[kk], dk_b + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      if (tid == 0) mbar_arrive(&sm.empty[s]);
    }
    const long long hd = (long long)heads * D;
    store_rows(dq + (long long)b * n * hd + h * D, hd, dqa, row0, n, scale, tid);
  }
}

constexpr int kDkdvSmemBytes = sizeof(DkdvSmem) + 1024;
constexpr int kDqSmemBytes = sizeof(DqSmem) + 1024;

// The three launches of one backward; `ev` (four events or null) brackets
// them for vda_flash_attention_bwd_split.
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
               const void* lse, void* aux, void* dq, void* dk, void* dv, int batch, int n,
               int heads, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
               long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
               float scale, cudaStream_t st, cudaEvent_t* ev) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const int np = (n + kRes - 1) / kRes * kRes;
  const long long g_sn = (long long)heads * D, g_sb = g_sn * n;
  // runtime calls before the maps: they make the context current (make_map)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_step, g_step, k_res, v_res, q_res, g_res, k_step, v_step;
  if (!make_map(&q_step, q, batch, n, heads, q_sb, q_sn, q_sh, kStep) ||
      !make_map(&g_step, g, batch, n, heads, g_sb, g_sn, D, kStep) ||
      !make_map(&k_res, k, batch, n, heads, k_sb, k_sn, k_sh, kRes) ||
      !make_map(&v_res, v, batch, n, heads, v_sb, v_sn, v_sh, kRes) ||
      !make_map(&q_res, q, batch, n, heads, q_sb, q_sn, q_sh, kRes) ||
      !make_map(&g_res, g, batch, n, heads, g_sb, g_sn, D, kRes) ||
      !make_map(&k_step, k, batch, n, heads, k_sb, k_sn, k_sh, kStep) ||
      !make_map(&v_step, v, batch, n, heads, v_sb, v_sn, v_sh, kStep))
    return static_cast<int>(cudaErrorInvalidValue);

  if (ev) cudaEventRecord(ev[0], st);
  const int bh_rows = batch * heads * np;
  float* auxp = static_cast<float*>(aux);
  flash_bwd_prep_kernel<<<(bh_rows + 31) / 32, 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), static_cast<const float*>(lse),
      auxp, bh_rows, n, np, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ev) cudaEventRecord(ev[1], st);
  const dim3 grid((n + kRes - 1) / kRes, batch * heads);
  flash_bwd_dkdv_kernel<<<grid, 384, kDkdvSmemBytes, st>>>(
      q_step, k_res, v_res, g_step, auxp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, np,
      heads, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ev) cudaEventRecord(ev[2], st);
  flash_bwd_dq_kernel<<<grid, 384, kDqSmemBytes, st>>>(
      q_res, k_step, v_step, g_res, auxp, static_cast<bf16*>(dq), n, np, heads, scale_log2,
      scale);
  if (ev) cudaEventRecord(ev[3], st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `aux` is fp32 scratch of 2 * B * H * 128 * ceil(N / 128) floats.
extern "C" int vda_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g, const void* lse,
    void* aux, void* dq, void* dk, void* dv, int batch, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale, void* stream) {
  return launch_bwd(q, k, v, o, g, lse, aux, dq, dk, dv, batch, n, heads, q_sb, q_sn, q_sh,
                    k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale, static_cast<cudaStream_t>(stream),
                    nullptr);
}

// The backward's split: `iters` backwards with CUDA events around each of
// the three launches; ms[0..2] gets the mean ms of the Delta pre-pass, the
// dK/dV kernel and the dQ kernel.  Synchronises the stream.
extern "C" int vda_flash_attention_bwd_split(
    const void* q, const void* k, const void* v, const void* o, const void* g, const void* lse,
    void* aux, void* dq, void* dk, void* dv, int batch, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale, void* stream, int iters,
    float* ms) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaEvent_t ev[4];
  for (auto& e : ev) cudaEventCreate(&e);
  ms[0] = ms[1] = ms[2] = 0.f;
  int err = 0;
  for (int it = 0; it < iters && err == 0; ++it) {
    err = launch_bwd(q, k, v, o, g, lse, aux, dq, dk, dv, batch, n, heads, q_sb, q_sn, q_sh,
                     k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale, st, ev);
    if (err == 0) err = static_cast<int>(cudaEventSynchronize(ev[3]));
    for (int i = 0; i < 3 && err == 0; ++i) {
      float t = 0.f;
      err = static_cast<int>(cudaEventElapsedTime(&t, ev[i], ev[i + 1]));
      ms[i] += t / iters;
    }
  }
  for (auto& e : ev) cudaEventDestroy(e);
  return err;
}
