// Kernel A on fp32 operands: flash-attention forward for the ViT's spatial
// attention under --fp32, with both products on the tensor cores in 3xTF32.
//
// Replaces the same TPU kernels as flash_attention.cu
// (video_depth_anything_tpu/ops/pallas_attention.py: _flash_kernel_native,
// _flash_kernel, _flash_kernel_fast, _flash_kernel_single) where the JAX
// package runs them on fp32 inputs: their gates check no dtype and their
// bodies compute in the input dtype, so p stays fp32 (it is cast to
// v.dtype) and both products are fp32 products.  Same domain as the bf16
// kernel: D = 64 and 192, any head count, exact or FAST, q, k and v read
// through (batch, token, head) strides (the fused qkv projection's views),
// any N.  Forward only: no JAX entry point trains in fp32.
//
// Bound on the H100: operations.  The products are 4 * N^2 * D * H * B
// FLOP; fp32-accurate on the tensor cores they are three TF32 products
// each ("3xTF32": every fp32 operand x is split into hi = rna(x) and lo =
// rna(x - hi), and a product is lo.hi + hi.lo + hi.hi, the small terms
// first, into one fp32 accumulator; lo.lo is below fp32's rounding), so 3 *
// 4 * N^2 * D * H * B FLOP at 495 TFLOP/s: 0.559 ms at vits 518x518 (B*T =
// 32, N = 1370, H = 6), against 1.377 ms for the same products on the CUDA
// cores' fp32 FMA (67 TFLOP/s) and 67 MB of traffic (0.02 ms).
//
// Route: wgmma with tf32 operands (hopper.cuh), the only way to the full
// tensor rate.  tf32 wgmma takes both operands K-major, B always from
// shared memory, A from shared memory or registers; each split operand
// has to be rounded by a thread, so no tile goes from TMA to a product
// as it lands.
// - A CTA is one (b, h) and 64 * NC query rows: a converter warpgroup and
//   NC consumer warpgroups of 64 rows (NC = 2 at D = 64, 1 at D = 192).
//   At D = 64 setmaxnreg gives the consumers 208 registers and the
//   converter 88: 2 * 128 * 208 + 128 * 88 = 64512, the 384 * 168 that
//   the launch holds (an increase past the CTA's pool would never return).
// - K and V arrive by TMA (fp32 tensor maps of the strided views, boxes
//   of 32 floats x KT keys in the 128-byte swizzle; keys past N zero-filled
//   and masked): K into the stage's K-hi tile, V into a raw tile.  The
//   converter rounds K in place (K hi) and writes K lo beside it, the same
//   swizzled positions; it transposes V into V^T hi and lo (keys
//   contiguous: P V's K-major B), its keys permuted within each group of
//   8 (logical position j holds key 2j for j < 4, key 2(j - 4) + 1 after)
//   so that the S accumulator's columns (2c, 2c + 1) are P's tf32 A
//   fragment (c, c + 4) with no shuffle.  Then fence.proxy.async and an
//   mbarrier hand-off per operand: K and V are released separately (after
//   S and after P V), so the next K lands and is split during the
//   softmax and P V.
// - Q: each consumer thread loads its rows once, scaled by scale * log2 e
//   in fp32 (the scores come out in the exp2 domain), and splits them.  At
//   D = 64 Q hi stays in registers as tf32 A fragments (32) and Q lo goes
//   to shared memory (32 KB): hi and lo both in registers (64), beside O's
//   32 accumulators and P's hi and lo (64), passed the 168 registers that
//   ptxas allows a thread of a 384-thread CTA, and spilled.  S = Q K^T is
//   wgmma m64n64k8, 3 x 8 steps: lo.hi from shared memory, the two hi
//   passes with A from registers.  At D = 192 Q's hi and lo (96 KB for 64
//   rows) both go to shared memory (O alone takes 96 registers), and S is
//   m64n32k8 with both operands there, 3 x 24 steps.
// - Online softmax on the S accumulator in fp32 (the hardware exp2),
//   running max m, rescale by exp2(m_old - m_new); FAST keeps m = 0 and
//   never rescales (the JAX ':fast' contract: exact while the scaled
//   logits stay inside fp32's exp2 domain, about +-88).  p is split into A
//   fragments in registers; O += P V is wgmma m64n64k8 per 64 columns of O
//   (one at D = 64, three at D = 192), 3 x KT / 8 steps, B = V^T hi or lo.
// - Shared memory: a stage is K hi (TMA lands here), K lo, V raw, V^T hi,
//   V^T lo, KT * D floats each: at D = 64, KT = 64 keys, two stages, 160
//   KB beside Q lo's 32 KB; at D = 192, KT = 32, one stage (120 KB) beside
//   Q's 96 KB.
// - mma.sync was not needed: every product here fits wgmma's operand rules
//   once V is transposed by the converter, which rounds it anyway.
#include <math_constants.h>

#include "hopper.cuh"

namespace {

template <int D>
struct Lay {
  static constexpr int NC = D == 64 ? 2 : 1;     // consumer warpgroups (64 query rows each)
  static constexpr int KT = D == 64 ? 64 : 32;   // keys per tile
  static constexpr int ST = D == 64 ? 2 : 1;     // ring stages
  static constexpr bool QREG = D == 64;          // Q hi in registers (Q lo in smem), else both in smem
  static constexpr int TILE = KT * D;            // floats of a K, raw V or V^T tile
  static constexpr int QF = (QREG ? NC : 2) * 64 * D;  // Q lo tiles (D = 64), Q hi and lo (192)
  static constexpr int STAGE = 5 * TILE;         // K hi, K lo, V raw, V^T hi, V^T lo
  static constexpr int FLOATS = QF + ST * STAGE;
  static constexpr int BARS = 6 * ST;            // per stage: K raw, V raw, K, V full; K, V empty
  static constexpr int BYTES = FLOATS * 4 + BARS * 8 + 1024;
};

template <int D>
struct QRegs {  // a consumer thread's Q hi fragments (D = 64)
  uint32_t hi[Lay<D>::QREG ? D / 8 : 1][4];
};

struct Args {
  const float* q;
  float* o;
  int n, heads;
  long long q_sb, q_sn, q_sh, o_sb, o_sn, o_sh;
  float scale_log2;
};

__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// The k8 step kk of a K-major tile of `rows` rows x D floats (D / 32
// panels of rows x 128 B).
template <int ROWS>
__device__ __forceinline__ uint64_t kstep(const float* tile, int kk) {
  return desc_sw128(tile + (kk / 4) * ROWS * 32) + 2 * (kk % 4);
}

// S = Q K^T at D = 64 in three passes (lo.hi, hi.lo, hi.hi): Q lo from
// shared memory (this warpgroup's 64 rows), Q hi from registers.
template <int D, int KT>
__device__ __forceinline__ void scores_reg(float (&sc)[32], const float* qlo, const QRegs<D>& q,
                                           const float* khi, const float* klo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss_n64(sc, kstep<64>(qlo, kk), kstep<KT>(khi, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_rs_n64(sc, q.hi[kk], kstep<KT>(klo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_rs_n64(sc, q.hi[kk], kstep<KT>(khi, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// S = Q K^T at D = 192 in three passes, both operands in shared memory.
template <int D, int KT>
__device__ __forceinline__ void scores_smem(float (&sc)[16], const float* qhi, const float* qlo,
                                            const float* khi, const float* klo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss_n32(sc, kstep<64>(qlo, kk), kstep<KT>(khi, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss_n32(sc, kstep<64>(qhi, kk), kstep<KT>(klo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss_n32(sc, kstep<64>(qhi, kk), kstep<KT>(khi, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// O += P V in three passes (lo.hi, hi.lo, hi.hi); V^T tiles are KT / 32
// panels of D rows x 32 keys, O's 64-column blocks one wgmma each.
template <int D, int KT>
__device__ __forceinline__ void pv(float (&acc)[D / 64][32], const uint32_t (&phi)[KT / 8][4],
                                   const uint32_t (&plo)[KT / 8][4], const float* vthi,
                                   const float* vtlo) {
  const auto vstep = [](const float* vt, int kk, int nb) {
    return desc_sw128(vt + (kk / 4) * D * 32 + nb * 64 * 32) + 2 * (kk % 4);
  };
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) wgmma_tf32_rs_n64(acc[nb], plo[kk], vstep(vthi, kk, nb), 1);
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) wgmma_tf32_rs_n64(acc[nb], phi[kk], vstep(vtlo, kk, nb), 1);
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) wgmma_tf32_rs_n64(acc[nb], phi[kk], vstep(vthi, kk, nb), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) fence_regs(acc[nb]);
}

// V (raw, KT keys x D, D / 32 swizzled panels) -> V^T hi and lo (KT / 32
// swizzled panels of D rows x 32 keys, keys permuted within each 8).  A
// warp takes 32 keys x 4 dims an item: its 16-byte reads hit 8 rows in 8
// bank groups, its 4-byte writes one 128-byte row.
template <int D, int KT>
__device__ __forceinline__ void transpose_split(const float* vraw, float* vthi, float* vtlo,
                                                int tid) {
  const int lane = tid & 31, w = tid >> 5;
  const int jj = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);  // key's logical position
#pragma unroll 4
  for (int it = w; it < (KT / 32) * (D / 4); it += 4) {
    const int kb = it / (D / 4), dq = it % (D / 4);
    const int key = 32 * kb + lane;
    const float4 x = *reinterpret_cast<const float4*>(
        vraw + (dq / 8) * KT * 32 + key * 32 + (((dq % 8) ^ (key & 7)) << 2));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * dq + e;
      const int off = kb * D * 32 + d * 32 + ((((jj >> 2) ^ (d & 7)) << 2) | (jj & 3));
      float hi, lo;
      split_tf32(xs[e], hi, lo);
      vthi[off] = hi;
      vtlo[off] = lo;
    }
  }
}

template <int D, bool FAST>
__global__ void __launch_bounds__(128 * (Lay<D>::NC + 1), 1) flash_fwd_f32(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Lay<D>;
  constexpr int KT = L::KT, ST = L::ST, TILE = L::TILE;
  extern __shared__ unsigned char smem_raw[];
  float* base = &aligned_smem<float>(smem_raw);
  // Q lo of each consumer warpgroup (D = 64), or Q hi then Q lo (D = 192):
  // D / 32 panels of 64 rows x 32 floats each
  float* qs = base;
  float* ring = base + L::QF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::FLOATS);
  uint64_t *kraw = bars, *vraw_full = bars + ST, *kfull = bars + 2 * ST, *vfull = bars + 3 * ST;
  uint64_t *kempty = bars + 4 * ST, *vempty = bars + 5 * ST;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * 64 * L::NC;
  const int n = a.n;
  const int n_tiles = (n + KT - 1) / KT;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kraw[s], 1);
      mbar_init(&vraw_full[s], 1);
      mbar_init(&kfull[s], 128);  // every converter thread, after its fence
      mbar_init(&vfull[s], 128);
      mbar_init(&kempty[s], L::NC);  // one arrival per consumer warpgroup
      mbar_init(&vempty[s], L::NC);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // the converter: TMA in, rounded splits out
    if constexpr (L::NC == 2) setmaxnreg_dec<88>();
    auto load = [&](const CUtensorMap* map, float* dst, uint64_t* bar, int j) {
      mbar_arrive_expect_tx(bar, TILE * 4);
#pragma unroll
      for (int p = 0; p < D / 32; ++p) tma_load_4d(dst + p * KT * 32, map, bar, 32 * p, h, j * KT, b);
    };
    if (tid == 0)
      for (int j = 0; j < ST && j < n_tiles; ++j) {
        float* st = ring + j * L::STAGE;
        load(&tk, st, &kraw[j], j);
        load(&tv, st + 2 * TILE, &vraw_full[j], j);
      }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t ph = (j / ST) & 1;
      float* st = ring + s * L::STAGE;
      float4* khi = reinterpret_cast<float4*>(st);
      float4* klo = reinterpret_cast<float4*>(st + TILE);
      mbar_wait(&kraw[s], ph);
#pragma unroll 4
      for (int i = tid; i < TILE / 4; i += 128) {
        float4 hi, lo;
        split4(khi[i], hi, lo);
        khi[i] = hi;
        klo[i] = lo;
      }
      fence_async_smem();
      mbar_arrive(&kfull[s]);
      mbar_wait(&vraw_full[s], ph);
      if (j >= ST) mbar_wait(&vempty[s], ((j / ST) - 1) & 1);  // P V of tile j - ST is done
      transpose_split<D, KT>(st + 2 * TILE, st + 3 * TILE, st + 4 * TILE, tid);
      fence_async_smem();
      mbar_arrive(&vfull[s]);
      bar_sync(1, 128);  // every converter thread is done with this stage's raw V
      if (tid < 32 && j + ST < n_tiles) {  // warp 0, converged
        if (tid == 0) load(&tv, st + 2 * TILE, &vraw_full[s], j + ST);
        mbar_wait(&kempty[s], ph);  // S of tile j is done with K hi and lo
        if (tid == 0) load(&tk, st, &kraw[s], j + ST);
        __syncwarp();
      }
    }
  } else {  // consumers: query rows (wg - 1) * 64 .. + 64 of the CTA's
    if constexpr (L::NC == 2) setmaxnreg_inc<208>();
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
    const int r0 = q0 + (wg - 1) * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
    const float* qb = a.q + b * a.q_sb + h * a.q_sh;
    QRegs<D> qr;
    // this warpgroup's Q lo (D = 64) or Q hi and lo (D = 192) tiles
    float* qlo = qs + (L::QREG ? (wg - 1) * 64 * D : 64 * D);
    const auto qoff = [](int row, int col) {  // (row, col) of a 64-row tile in its swizzled panel
      return (col / 32) * 64 * 32 + row * 32 + ((((col % 32) >> 2) ^ (row & 7)) << 2) + (col & 3);
    };
    if constexpr (L::QREG) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + 8 * (r & 1), col = 8 * kk + c + 4 * (r >> 1);
          const float x = row < n ? qb[(long long)row * a.q_sn + col] * a.scale_log2 : 0.f;
          float hi, lo;
          split_tf32(x, hi, lo);
          qr.hi[kk][r] = __float_as_uint(hi);
          qlo[qoff(warp * 16 + g + 8 * (r & 1), col)] = lo;
        }
    } else {
      for (int i = tid; i < 64 * D / 4; i += 128) {
        const int row = i / (D / 4), dq = i % (D / 4);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + row < n)
          x = *reinterpret_cast<const float4*>(qb + (long long)(q0 + row) * a.q_sn + 4 * dq);
        x = make_float4(x.x * a.scale_log2, x.y * a.scale_log2, x.z * a.scale_log2,
                        x.w * a.scale_log2);
        float4 hi, lo;
        split4(x, hi, lo);
        *reinterpret_cast<float4*>(qs + qoff(row, 4 * dq)) = hi;
        *reinterpret_cast<float4*>(qlo + qoff(row, 4 * dq)) = lo;
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);  // this warpgroup's Q tiles are written
    // Under FAST the running max stays 0: no max pass and no rescale.
    float m_i[2] = {FAST ? 0.f : -CUDART_INF_F, FAST ? 0.f : -CUDART_INF_F};
    float l_i[2] = {0.f, 0.f};
    float acc[D / 64][32];
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const uint32_t ph = (j / ST) & 1;
      const float* st = ring + s * L::STAGE;
      mbar_wait(&kfull[s], ph);
      float sc[KT / 2];  // the m64nKT accumulator: rows g, g + 8; keys 8t + 2c, + 1
      if constexpr (L::QREG)
        scores_reg<D, KT>(sc, qlo, qr, st, st + TILE);
      else
        scores_smem<D, KT>(sc, qs, qlo, st, st + TILE);
      if (tid == 0) mbar_arrive(&kempty[s]);

      // keys at or past N (TMA's zero rows score 0, not -inf)
      const int valid = n - j * KT;
      if (valid < KT) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          if ((i >> 2) * 8 + 2 * c + (i & 1) >= valid) sc[i] = -CUDART_INF_F;
      }
      if constexpr (!FAST) {
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float m_new = fmaxf(m_i[rr], mx[rr]);
          const float alpha = exp2_approx(m_i[rr] - m_new);
          m_i[rr] = m_new;
          l_i[rr] *= alpha;
#pragma unroll
          for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              acc[nb][4 * t + 2 * rr] *= alpha;
              acc[nb][4 * t + 2 * rr + 1] *= alpha;
            }
        }
      }
      // p in fp32, split into tf32 A fragments: S's columns (2c, 2c + 1) of
      // each 8 keys are the fragment's (c, c + 4) (V^T's key permutation)
      uint32_t phi[KT / 8][4], plo[KT / 8][4];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const float p = exp2_approx(sc[i] - m_i[(i >> 1) & 1]);
        l_i[(i >> 1) & 1] += p;
        float hi, lo;
        split_tf32(p, hi, lo);
        const int r = ((i & 1) << 1) | ((i >> 1) & 1);
        phi[i >> 2][r] = __float_as_uint(hi);
        plo[i >> 2][r] = __float_as_uint(lo);
      }
      mbar_wait(&vfull[s], ph);
      pv<D, KT>(acc, phi, plo, st + 3 * TILE, st + 4 * TILE);
      if (tid == 0) mbar_arrive(&vempty[s]);
    }

    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_i[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[rr] = 1.f / l;
    }
    float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = 64 * nb + 8 * t + 2 * c;
        if (r0 < n)
          *reinterpret_cast<float2*>(ob + (long long)r0 * a.o_sn + col) =
              make_float2(acc[nb][4 * t] * inv[0], acc[nb][4 * t + 1] * inv[0]);
        if (r0 + 8 < n)
          *reinterpret_cast<float2*>(ob + (long long)(r0 + 8) * a.o_sn + col) =
              make_float2(acc[nb][4 * t + 2] * inv[1], acc[nb][4 * t + 3] * inv[1]);
      }
  }
}

template <int D, bool FAST>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
           const long long* st, float scale, cudaStream_t stream) {
  using L = Lay<D>;
  auto kern = flash_fwd_f32<D, FAST>;
  // a runtime call before the maps: it makes the context current (make_map)
  const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tk, tv;
  if (!make_map(&tk, k, batch, n, heads, st[3], st[4], st[5], L::KT, D,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !make_map(&tv, v, batch, n, heads, st[6], st[7], st[8], L::KT, D,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.o = static_cast<float*>(o);
  a.n = n;
  a.heads = heads;
  a.q_sb = st[0];
  a.q_sn = st[1];
  a.q_sh = st[2];
  a.o_sb = st[9];
  a.o_sn = st[10];
  a.o_sh = st[11];
  a.scale_log2 = scale * 1.4426950408889634f;
  dim3 grid((n + 64 * L::NC - 1) / (64 * L::NC), batch * heads);
  kern<<<grid, 128 * (L::NC + 1), L::BYTES, stream>>>(tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head_dim is 64 or 192; q, k and v must be TMA-describable (16-byte
// aligned bases, strides multiples of 4 elements), else, or for another
// head_dim, cudaErrorInvalidValue.  fast != 0 selects the no-max variant.
extern "C" int vda_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return 0;
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return fast ? launch<64, true>(q, k, v, o, batch, n, heads, st, scale, s)
                : launch<64, false>(q, k, v, o, batch, n, heads, st, scale, s);
  if (head_dim == 192)
    return fast ? launch<192, true>(q, k, v, o, batch, n, heads, st, scale, s)
                : launch<192, false>(q, k, v, o, batch, n, heads, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
