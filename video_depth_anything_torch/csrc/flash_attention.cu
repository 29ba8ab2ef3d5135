// Kernel A: flash-attention forward for the ViT's spatial attention.
//
// Replaces the TPU kernels video_depth_anything_tpu/ops/pallas_attention.py:
// _flash_kernel_native (via flash_attention_native, padded N <= 2048),
// _flash_kernel (via _flash_forward / spatial_flash_attention, the 512-key
// online-softmax path for longer rows, e.g. 518x924 frames with N = 2443),
// _flash_kernel_fast (the no-max variant of the latter) and
// _flash_kernel_single (the whole-row kernel for odd head counts and
// D = 192, exact or fast).  One kernel serves all four: it loops over key
// tiles with an online fp32 softmax, so any N works, and it reads q, k and
// v through generic (batch, token, head) strides straight from the
// (B, N, 3*H*D) qkv projection -- no transposes and no pad copies, and any
// head count.
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
// Template <D, FAST>, instantiated at D in {64, 192}:
//   * Tiles: 64 queries per CTA (4 warps x 16 rows), 64 keys per step, in
//     3 * 64 * (D + 8) bf16 of shared memory: 27.6 KB of static shared
//     memory at D = 64 (compile-time addresses: with dynamic shared memory
//     the exact D = 64 kernel ran 12-15 % slower on the H100 in
//     chip_smoke.py, the fast one no slower), 76.8 KB of dynamic
//     shared memory at D = 192, above the 48 KB a launch gets without
//     cudaFuncAttributeMaxDynamicSharedMemorySize.  At D = 64 each warp
//     keeps its Q fragments in registers; at D = 192 (48 more registers
//     per thread beside a 96-float accumulator) it reads them from shared
//     memory at every key tile.
//   * FAST is the TPU kernels' no-max softmax (pallas_attention.py:123-156,
//     :183-192, :233-234): the running max stays 0 and p = exp2(s * scale *
//     log2(e)) with no rescale.  The quotient is the exact softmax's while
//     the scaled logits stay inside fp32's exp2 domain (about +-88 natural
//     units): above that the hardware exp2f overflows to inf and the row
//     turns to nan, where the TPU's polynomial clamps.  That is the JAX
//     contract of the ':fast' suffix; nothing here switches variants.
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

namespace {

constexpr int BM = 64;
constexpr int BN = 64;

template <int D>
__host__ __device__ constexpr int smem_elems() { return (BM + 2 * BN) * tile_lds<D>(); }
template <int D>
constexpr bool kStaticSmem = D <= 64;

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
  constexpr bool kQInRegs = D <= 64;
  bf16* sQ;
  if constexpr (kStaticSmem<D>) {
    __shared__ __align__(16) bf16 smem_static[smem_elems<D>()];
    sQ = smem_static;
  } else {
    extern __shared__ __align__(16) unsigned char smem_dynamic[];
    sQ = reinterpret_cast<bf16*>(smem_dynamic);
  }
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
  uint32_t qf[kQInRegs ? KD : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], q_row + kk * 16);
  }

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
      uint32_t a_smem[4];
      const uint32_t* a = a_smem;
      if constexpr (kQInRegs)
        a = qf[kk];
      else
        ldmatrix_x4(a_smem[0], a_smem[1], a_smem[2], a_smem[3], q_row + kk * 16);
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
  constexpr int smem = kStaticSmem<D> ? 0 : smem_elems<D>() * 2;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((n + BM - 1) / BM, batch * heads);
  flash_fwd_kernel<D, FAST><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head_dim is 64 or 192 (anything else returns cudaErrorInvalidValue);
// fast != 0 selects the no-max variant.
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
    return fast ? launch<64, true>(q, k, v, o, batch, n, heads, st, scale, lse, s)
                : launch<64, false>(q, k, v, o, batch, n, heads, st, scale, lse, s);
  if (head_dim == 192)
    return fast ? launch<192, true>(q, k, v, o, batch, n, heads, st, scale, lse, s)
                : launch<192, false>(q, k, v, o, batch, n, heads, st, scale, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
