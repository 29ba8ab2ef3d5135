// Kernel A: flash-attention forward for the ViT's spatial attention.
//
// Replaces the TPU kernels video_depth_anything_tpu/ops/pallas_attention.py:
// _flash_kernel_native (via flash_attention_native, padded N <= 2048) and
// _flash_kernel (via _flash_forward / spatial_flash_attention, the 512-key
// online-softmax path for longer rows, e.g. 518x924 frames with N = 2443).
// One kernel serves both: it loops over key tiles with an online fp32
// softmax, so any N works, and it reads q, k and v through generic
// (batch, token, head) strides straight from the (B, N, 3*H*D) qkv
// projection -- no transposes and no pad copies.
//
// Bound on the H100: compute.  At 518x924 with B*T = 32 a call does
// 4*N^2*D*H*B = 2.9e11 FLOP (0.30 ms at 989 TFLOP/s) and moves ~240 MB
// (0.07 ms).  The design keeps both products on the tensor cores
// (mma.sync m16n8k16 bf16, fp32 accumulate), keeps S and P in registers
// (never in memory), and uses the hardware exp2 with log2(e) folded into
// the score scale.  The TPU's exp2 polynomial and ones-column row sum were
// VPU workarounds and are not carried over.  Loads are plain synchronous
// 16-byte copies into shared memory; cp.async/TMA pipelining and wgmma
// are later work.
//
// Tiles: 64 queries per CTA (4 warps x 16 rows), 64 keys per step, D = 64.
// Pad keys of the ragged last tile are masked to -inf; pad query rows are
// computed on zeros and never stored.
//
// For training, the kernel also writes each real query row's log-sum-exp
// in the exp2 domain, lse = m + log2(l) over the scaled scores
// s * scale * log2(e), fp32, laid out (B, H, N); the backward kernels
// (flash_attention_bwd.cu) recompute P = exp2(s * scale * log2(e) - lse)
// from it.  Inference passes a null pointer and writes nothing.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int LDS = kTileLds;

__global__ void __launch_bounds__(128) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, float* __restrict__ lse) {
  __shared__ __align__(16) bf16 sQ[BM * LDS];
  __shared__ __align__(16) bf16 sK[BN * LDS];
  __shared__ __align__(16) bf16 sV[BN * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;

  load_tile64(sQ, qb, q_sn, q0, n, tid);
  __syncthreads();

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                &sQ[(warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8]);

  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const int mi = lane >> 3, r8 = lane & 7;
  const int n_tiles = (n + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile64(sK, kb, k_sn, k0, n, tid);
    load_tile64(sV, vb, v_sn, k0, n, tid);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    &sK[(np * 16 + r8 + (mi >> 1) * 8) * LDS + kk * 16 + (mi & 1) * 8]);
        mma_bf16_16816(s[2 * np], qf[kk], b0, b1);
        mma_bf16_16816(s[2 * np + 1], qf[kk], b2, b3);
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
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_i[rr], mx[rr]);
      const float alpha = exp2f(m_i[rr] - m_new);
      m_i[rr] = m_new;
      l_i[rr] *= alpha;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][2 * rr] *= alpha;
        acc[t][2 * rr + 1] *= alpha;
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
      for (int dp = 0; dp < 4; ++dp) {
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
  for (int t = 0; t < 8; ++t) {
    const int col = t * 8 + (lane & 3) * 2;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * o_sn + col) =
          pack_bf16x2(acc[t][0] * inv[0], acc[t][1] * inv[0]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * o_sn + col) =
          pack_bf16x2(acc[t][2] * inv[1], acc[t][3] * inv[1]);
  }
}

}  // namespace

extern "C" int vda_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, void* lse, void* stream) {
  dim3 grid((n + BM - 1) / BM, batch * heads);
  flash_fwd_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, heads, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
      o_sb, o_sn, o_sh, scale * 1.4426950408889634f, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
