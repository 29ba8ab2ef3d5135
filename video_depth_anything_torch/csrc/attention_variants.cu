// Kernel A's softmax-chain probe on mma.sync: the TPU probe kernel that
// attention_variants_hopper.cu does not hold.
//
// Replaces scripts/bench_softmax_chain.py make_kernel's kern (seven modes).
// The spatial probes _kernel_ilv, _kernel_chunk and _kernel_sbf16 of
// scripts/bench_spatial_variants.py are the Hopper kernels of
// attention_variants_hopper.cu.  The numerics are the TPU kernel's: fp32
// scores, no mask (Nk a multiple of 64), one of seven elementwise chains,
// P rounded to bf16 before P V, fp32 accumulate.  The chain modes sexp and
// pexp are the Schraudolph and cubic bit tricks on the FMA units; exp,
// exact, bf16s and bf16x use the hardware exponential (MUFU ex2).  Which of
// these the card pays for is the question the probe asks.
//
// Bound on the H100: tensor-core FLOPs, 2 * 2 * 1376 * 1408 * 64 * 512 FLOP
// (0.257 ms at 989 TFLOP/s).  The design is Kernel A's first skeleton: 64
// query rows per CTA, 16 per warp, 64-key tiles in shared memory, QK^T and
// P V on mma.sync m16n8k16 (bf16 in, fp32 accumulate), S and P in
// registers.  Its Hopper redesign is later work.
//
//   chain_kernel<MODE>   kern's seven chains on (BH, N, 64).  exact keeps an
//                        online max with rescale (fp32 exp: the difference
//                        from the global max is fp32 rounding, then bf16
//                        rounding of P); bf16x rounds s - m to bf16, so an
//                        online rescale would compute another function: it
//                        takes the global max in a first pass over the key
//                        tiles (QK^T twice).  The output is the
//                        unnormalised (P V)[:, :64], so the kernel reads
//                        only V's first 64 columns.
#include "common.cuh"

namespace {

constexpr int D = 64;      // the head width of every probe
constexpr int BM = 64;     // query rows per CTA (16 per warp)
constexpr int BN = 64;     // keys per tile
constexpr int LDS = kTileLds;
constexpr int TILE = BN * LDS;  // one K or V tile in shared memory (elements)

// The warp's 16 query rows (row0..) of one head as m16n8k16 A fragments;
// rows >= n zero.
__device__ __forceinline__ void load_q_frags(uint32_t qf[4][4], const bf16* q, long long stride,
                                             int row0, int n, int lane) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a0 (g, 2c), a1 (g+8, 2c), a2 (g, 8+2c), a3 (g+8, 8+2c)
      const int row = row0 + g + (r & 1) * 8, col = kk * 16 + (r >> 1) * 8 + c2;
      qf[kk][r] = row < n ? *reinterpret_cast<const uint32_t*>(q + (long long)row * stride + col)
                          : 0u;
    }
}

// s = Q K^T for the warp's 16 rows against one 64-key tile in shared memory.
__device__ __forceinline__ void qk_tile(float s[8][4], const uint32_t qf[4][4], const bf16* sK,
                                        int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, &sK[(np * 16 + r8 + (mi >> 1) * 8) * LDS + kk * 16 + (mi & 1) * 8]);
      mma_bf16_16816(s[2 * np], qf[kk], b0, b1);
      mma_bf16_16816(s[2 * np + 1], qf[kk], b2, b3);
    }
}

// P (fp32, accumulator layout) rounded to bf16 A fragments.
__device__ __forceinline__ void pack_p(uint32_t p[4][4], const float s[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    p[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    p[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc += P V for one 64-key tile of V (64 columns) in shared memory.
__device__ __forceinline__ void pv_tile(float acc[8][4], const uint32_t p[4][4], const bf16* sV,
                                        int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        &sV[(kk * 16 + r8 + (mi & 1) * 8) * LDS + (dp * 2 + (mi >> 1)) * 8]);
      mma_bf16_16816(acc[2 * dp], p[kk], b0, b1);
      mma_bf16_16816(acc[2 * dp + 1], p[kk], b2, b3);
    }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// out rows (row0 + g, row0 + g + 8) = acc / l[row half], rounded to bf16;
// rows >= n are not stored.  l is the lane's row sums, already reduced.
__device__ __forceinline__ void store_rows(bf16* o, long long stride, int row0, int n,
                                           const float acc[8][4], const float l[2], int lane) {
  const int r0 = row0 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = t * 8 + (lane & 3) * 2;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(o + (long long)r0 * stride + col) =
          pack_bf16x2(acc[t][0] / l[0], acc[t][1] / l[0]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(o + (long long)(r0 + 8) * stride + col) =
          pack_bf16x2(acc[t][2] / l[1], acc[t][3] / l[1]);
  }
}

// -------------------------------------------------------------- chain ----
enum Mode { GEMMS, EXP, EXACT, SEXP, PEXP, BF16S, BF16X };

template <int MODE>
__global__ void __launch_bounds__(128) chain_kernel(const bf16* __restrict__ q,
                                                    const bf16* __restrict__ k,
                                                    const bf16* __restrict__ v,
                                                    bf16* __restrict__ o, int nq, int nk,
                                                    int dv) {
  __shared__ __align__(16) bf16 smem[2 * TILE];
  bf16 *sK = smem, *sV = smem + TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = blockIdx.y;
  const bf16* qb = q + bh * nq * D;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * dv;
  const int row0 = blockIdx.x * BM + warp * 16;

  uint32_t qf[4][4];
  load_q_frags(qf, qb, D, row0, nq, lane);
  float s[8][4], acc[8][4];
  float m[2] = {MODE == EXACT ? -INFINITY : 0.f, MODE == EXACT ? -INFINITY : 0.f};
  uint32_t p[4][4];
  zero_acc(acc);

  if constexpr (MODE == BF16X) {  // the global row max of the bf16 scores
    m[0] = m[1] = -INFINITY;
    for (int k0 = 0; k0 < nk; k0 += BN) {
      __syncthreads();
      load_tile64(sK, kb, D, k0, nk, tid);
      __syncthreads();
      qk_tile(s, qf, sK, lane);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], bf16_round(s[t][e]));
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
  }
  for (int k0 = 0; k0 < nk; k0 += BN) {
    __syncthreads();
    load_tile64(sK, kb, D, k0, nk, tid);
    load_tile64(sV, vb, dv, k0, nk, tid);  // V's first 64 columns only
    __syncthreads();
    qk_tile(s, qf, sK, lane);
    if constexpr (MODE == EXACT) {  // online max: rescale acc to the new max
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * rr], s[t][2 * rr + 1]));
        mx = quad_max(mx);
        const float alpha = __expf(m[rr] - mx);
        m[rr] = mx;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          acc[t][2 * rr] *= alpha;
          acc[t][2 * rr + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[t][e];
        float pe;
        if constexpr (MODE == GEMMS) {
          pe = x;
        } else if constexpr (MODE == EXP) {
          pe = exp2f(x);
        } else if constexpr (MODE == EXACT) {
          pe = __expf(x - m[e >> 1]);
        } else if constexpr (MODE == SEXP) {
          pe = __int_as_float(__float2int_rz(fmaf(x, 8388608.f, 1065353216.f)));
        } else if constexpr (MODE == PEXP) {
          const float xi = floorf(x), xf = x - xi;
          const float sc = __int_as_float(int(unsigned(__float2int_rz(xi) + 127) << 23));
          pe = sc * fmaf(xf, fmaf(xf, fmaf(xf, 0.0779731f, 0.2288332f), 0.6951937f), 1.f);
        } else if constexpr (MODE == BF16S) {
          pe = bf16_round(exp2f(bf16_round(x)));
        } else {  // BF16X
          pe = bf16_round(exp2f(bf16_round(bf16_round(x) - m[e >> 1])));
        }
        s[t][e] = pe;
      }
    pack_p(p, s);
    pv_tile(acc, p, sV, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows(o + bh * nq * D, D, row0, nq, acc, one, lane);
}

template <typename K, typename... A>
int launch(K kernel, dim3 grid, cudaStream_t st, A... args) {
  kernel<<<grid, 128, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Chain probe: q (bh, nq, 64), k (bh, nk, 64), v (bh, nk, dv) contiguous
// bf16, nk a multiple of 64, dv >= 64; o (bh, nq, 64).  mode indexes
// (gemms, exp, exact, sexp, pexp, bf16s, bf16x).
extern "C" int vda_chain(const void* q, const void* k, const void* v, void* o, int bh, int nq,
                         int nk, int dv, int mode, void* stream) {
  const dim3 grid((nq + BM - 1) / BM, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  switch (mode) {
    case GEMMS: return launch(chain_kernel<GEMMS>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    case EXP: return launch(chain_kernel<EXP>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    case EXACT: return launch(chain_kernel<EXACT>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    case SEXP: return launch(chain_kernel<SEXP>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    case PEXP: return launch(chain_kernel<PEXP>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    case BF16S: return launch(chain_kernel<BF16S>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    case BF16X: return launch(chain_kernel<BF16X>, grid, st, qb, kb, vb, ob, nq, nk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
