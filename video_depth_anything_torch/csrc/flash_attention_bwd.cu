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
// FLOP (0.16 ms at 989 TFLOP/s) against ~50 MB moved (0.015 ms).  The
// design keeps every product on the tensor cores (mma.sync m16n8k16 bf16,
// fp32 accumulate), S, P, dP and dS in registers, and splits the work so
// that no two CTAs write the same output, with no atomics: the result is
// deterministic.
//   * flash_bwd_delta_kernel: Delta per (b, h, query row), 8 lanes a row.
//   * flash_bwd_dkdv_kernel: one CTA per (b, h, 64-key tile), 4 warps of 16
//     keys; K and V stay in registers as A fragments while the CTA walks
//     every 64-query tile; dK and dV accumulate in registers.
//   * flash_bwd_dq_kernel: one CTA per (b, h, 64-query tile), 4 warps of 16
//     queries; Q and dO stay in registers while it walks every key tile.
// Each kernel recomputes S and P (the forward's product runs three times
// per step in all); wgmma, TMA and double-buffered tiles are later work.
//
// Pad keys of the ragged last key tile get P = 0 in the dQ kernel and are
// never stored by the dK/dV kernel; pad query rows get P = 0 in the dK/dV
// kernel (they add nothing to dK, dV) and are never stored by the dQ
// kernel.  q, k and v may be strided (batch, token, head) views of the
// fused qkv projection; o, dO, dq, dk and dv are contiguous (B, N, H, D);
// lse and Delta are fp32 (B, H, N).
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BT = 64;  // rows of a query or key tile
constexpr int LDS = kTileLds;

// Delta[b, h, i] = sum_d o[b, i, h, d] * g[b, i, h, d] (fp32 products of bf16).
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ g, float* __restrict__ delta,
    int rows, int n, int heads) {
  const int r = blockIdx.x * 32 + (threadIdx.x >> 3);  // row of (B, N, H) order
  const int part = threadIdx.x & 7;
  float s = 0.f;
  if (r < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + (long long)r * D + part * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + (long long)r * D + part * 8);
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
  if (r < rows && part == 0) {
    const int h = r % heads;
    const int bi = r / heads;  // b * n + i
    delta[((long long)(bi / n) * heads + h) * n + bi % n] = s;
  }
}

// A fragments of this warp's 16 rows (all 64 columns) of a shared tile.
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[4][4], const bf16* tile, int warp,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk][0], f[kk][1], f[kk][2], f[kk][3],
                &tile[(warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8]);
}

// acc[16 x 64] += A[16 x 64 (D)] * T^T, T a shared [64 rows x 64 (D)] tile:
// the product over D with the tile's rows as the output columns.
__device__ __forceinline__ void mma_rows_t(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                           const bf16* tile, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, &tile[(np * 16 + r8 + (mi >> 1) * 8) * LDS + kk * 16 + (mi & 1) * 8]);
      mma_bf16_16816(acc[2 * np], a[kk], b0, b1);
      mma_bf16_16816(acc[2 * np + 1], a[kk], b2, b3);
    }
}

// acc[16 x 64 (D)] += X[16 x 64] * T, X in the accumulator layout (rounded
// to bf16 here), T a shared [64 rows x 64 (D)] tile: the product over the
// tile's rows.
__device__ __forceinline__ void mma_acc_t(float (&acc)[8][4], const float (&x)[8][4],
                                          const bf16* tile, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        &tile[(kk * 16 + r8 + (mi & 1) * 8) * LDS + (dp * 2 + (mi >> 1)) * 8]);
      mma_bf16_16816(acc[2 * dp], a, b0, b1);
      mma_bf16_16816(acc[2 * dp + 1], a, b2, b3);
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[t][e] = 0.f;
}

// Store this warp's 16 rows of a [16 x 64] fp32 accumulator, times `mul`,
// as bf16 into rows r0, r0 + 8 of a row-major matrix (row stride `ld`).
__device__ __forceinline__ void store_rows(bf16* out, long long ld, const float (&x)[8][4],
                                           int r0, int n, float mul, int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = t * 8 + (lane & 3) * 2;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * ld + col) =
          pack_bf16x2(x[t][0] * mul, x[t][1] * mul);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + 8) * ld + col) =
          pack_bf16x2(x[t][2] * mul, x[t][3] * mul);
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 sQ[BT * LDS];
  __shared__ __align__(16) bf16 sG[BT * LDS];
  __shared__ float sL[BT], sDelta[BT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * BT;
  const long long hd = (long long)heads * D;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* gb = g + (long long)b * n * hd + h * D;
  const float* lb = lse + (long long)blockIdx.y * n;
  const float* db = delta + (long long)blockIdx.y * n;

  // this warp's 16 keys: K and V rows as A fragments, for the whole loop
  uint32_t kf[4][4], vf[4][4];
  load_tile64(sQ, k + b * k_sb + h * k_sh, k_sn, k0, n, tid);
  load_tile64(sG, v + b * v_sb + h * v_sh, v_sn, k0, n, tid);
  __syncthreads();
  load_a_rows(kf, sQ, warp, lane);
  load_a_rows(vf, sG, warp, lane);

  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  const int n_tiles = (n + BT - 1) / BT;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * BT;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile64(sQ, qb, q_sn, q0, n, tid);
    load_tile64(sG, gb, hd, q0, n, tid);
    if (tid < BT) {
      const bool real = q0 + tid < n;
      sL[tid] = real ? lb[q0 + tid] : 0.f;
      sDelta[tid] = real ? db[q0 + tid] : 0.f;
    }
    __syncthreads();

    // P^T (keys x queries), normalised; pad queries 0
    float p[8][4];
    zero(p);
    mma_rows_t(p, kf, sQ, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + (lane & 3) * 2 + (e & 1);
        p[t][e] = q0 + col < n ? exp2f(p[t][e] * scale_log2 - sL[col]) : 0.f;
      }
    mma_acc_t(dva, p, sG, lane);  // dV += bf16(P^T) dO

    float dp[8][4];  // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta)
    zero(dp);
    mma_rows_t(dp, vf, sG, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[t][e] = p[t][e] * (dp[t][e] - sDelta[t * 8 + (lane & 3) * 2 + (e & 1)]);
    mma_acc_t(dka, dp, sQ, lane);  // dK += bf16(dS^T) Q
  }

  const int r0 = k0 + warp * 16 + (lane >> 2);
  const long long out_off = (long long)b * n * hd + h * D;
  store_rows(dk + out_off, hd, dka, r0, n, scale, lane);
  store_rows(dv + out_off, hd, dva, r0, n, 1.f, lane);
}

__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 sK[BT * LDS];
  __shared__ __align__(16) bf16 sV[BT * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BT;
  const long long hd = (long long)heads * D;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const long long out_off = (long long)b * n * hd + h * D;

  // this warp's 16 queries: Q and dO rows as A fragments, lse and Delta
  uint32_t qf[4][4], gf[4][4];
  load_tile64(sK, q + b * q_sb + h * q_sh, q_sn, q0, n, tid);
  load_tile64(sV, g + out_off, hd, q0, n, tid);
  __syncthreads();
  load_a_rows(qf, sK, warp, lane);
  load_a_rows(gf, sV, warp, lane);
  const int r0 = q0 + warp * 16 + (lane >> 2);
  float lrow[2], drow[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + rr * 8;
    lrow[rr] = row < n ? lse[(long long)blockIdx.y * n + row] : 0.f;
    drow[rr] = row < n ? delta[(long long)blockIdx.y * n + row] : 0.f;
  }

  float dqa[8][4];
  zero(dqa);
  const int n_tiles = (n + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile64(sK, kb, k_sn, k0, n, tid);
    load_tile64(sV, vb, v_sn, k0, n, tid);
    __syncthreads();

    float p[8][4];  // P (queries x keys), normalised; pad keys 0
    zero(p);
    mma_rows_t(p, qf, sK, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + t * 8 + (lane & 3) * 2 + (e & 1);
        p[t][e] = col < n ? exp2f(p[t][e] * scale_log2 - lrow[e >> 1]) : 0.f;
      }
    float dp[8][4];  // dP = dO V^T, then dS = P (dP - Delta)
    zero(dp);
    mma_rows_t(dp, gf, sV, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[t][e] = p[t][e] * (dp[t][e] - drow[e >> 1]);
    mma_acc_t(dqa, dp, sK, lane);  // dQ += bf16(dS) K
  }
  store_rows(dq + out_off, hd, dqa, r0, n, scale, lane);
}

}  // namespace

extern "C" int vda_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int batch, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const int rows = batch * n * heads;
  flash_bwd_delta_kernel<<<(rows + 31) / 32, 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), static_cast<float*>(delta), rows,
      n, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BT - 1) / BT, batch * heads);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(g);
  const float *lp = static_cast<const float*>(lse), *dp = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel<<<grid, 128, 0, st>>>(
      qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, heads,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<grid, 128, 0, st>>>(
      qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dq), n, heads,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
