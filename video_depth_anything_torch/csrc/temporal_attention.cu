// Kernel B: temporal attention core of the motion modules.
//
// Replaces video_depth_anything_tpu/ops/pallas_temporal.py:_temporal_kernel
// (via temporal_attention_window).  For every (batch, location, head) it
// attends over the frame axis: scores q_t . k_t' over the head dim, fp32
// softmax over T <= 32 frames, probabilities rounded to bf16, sum_t' p . v_t'
// accumulated in fp32, bf16 out -- the numerics of the JAX einsum path.
//
// Bound on the H100: memory.  At d = 8, 16 or 24 there is no tensor-core shape
// worth using and the arithmetic is ~2*T*d FLOP per loaded element; at vits
// m0 (one window) the call moves ~67 MB, ~20 us at 3.35 TB/s.  Design: one
// CTA per (batch, location) loads the location's T x C rows of q, k and v
// once with coalesced 16-byte loads along C into shared memory; warp h owns
// head h and lane t owns query frame t, so the whole softmax row lives in
// one thread's registers (no cross-lane reductions), and the k/v rows every
// lane reads are shared-memory broadcasts.  The output goes back through
// shared memory for a coalesced store.  The TPU's segment matrices and
// location packing were lane tricks and are not carried over.
#include "common.cuh"

namespace {

template <int DH>
__global__ void temporal_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, bf16* __restrict__ o, int T,
                                     int S, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + T * C;
  bf16* sV = sK + T * C;

  const int b = blockIdx.y, s = blockIdx.x;
  const int tid = threadIdx.x, h = tid >> 5, t = tid & 31;
  const int c8 = C / 8;
  for (int i = tid; i < T * c8; i += blockDim.x) {
    const int tt = i / c8, cc = (i % c8) * 8;
    const long long g = ((long long)(b * T + tt) * S + s) * C + cc;
    *reinterpret_cast<uint4*>(sQ + tt * C + cc) = *reinterpret_cast<const uint4*>(q + g);
    *reinterpret_cast<uint4*>(sK + tt * C + cc) = *reinterpret_cast<const uint4*>(k + g);
    *reinterpret_cast<uint4*>(sV + tt * C + cc) = *reinterpret_cast<const uint4*>(v + g);
  }
  __syncthreads();

  if (t < T) {
    const int col = h * DH;
    float qf[DH];
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      uint4 u = *reinterpret_cast<const uint4*>(sQ + t * C + col + i);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[i + j] = __bfloat162float(e[j]);
    }
    float sc[32];
    float mx = -INFINITY;
#pragma unroll
    for (int t2 = 0; t2 < 32; ++t2) {
      float acc = -INFINITY;
      if (t2 < T) {
        acc = 0.f;
#pragma unroll
        for (int i = 0; i < DH; i += 8) {
          uint4 u = *reinterpret_cast<const uint4*>(sK + t2 * C + col + i);
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc = fmaf(qf[i + j], __bfloat162float(e[j]), acc);
        }
        acc *= scale;
      }
      sc[t2] = acc;
      mx = fmaxf(mx, acc);
    }
    float sum = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < 32; ++t2) {
      sc[t2] = __expf(sc[t2] - mx);
      sum += sc[t2];
    }
    const float inv = 1.f / sum;
    float out[DH];
#pragma unroll
    for (int i = 0; i < DH; ++i) out[i] = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < 32; ++t2) {
      if (t2 < T) {
        const float p = bf16_round(sc[t2] * inv);
#pragma unroll
        for (int i = 0; i < DH; i += 8) {
          uint4 u = *reinterpret_cast<const uint4*>(sV + t2 * C + col + i);
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) out[i + j] = fmaf(p, __bfloat162float(e[j]), out[i + j]);
        }
      }
    }
    // this lane alone read this slice of sQ: overwrite it with the output
#pragma unroll
    for (int i = 0; i < DH; i += 2)
      *reinterpret_cast<uint32_t*>(sQ + t * C + col + i) = pack_bf16x2(out[i], out[i + 1]);
  }
  __syncthreads();
  for (int i = tid; i < T * c8; i += blockDim.x) {
    const int tt = i / c8, cc = (i % c8) * 8;
    const long long g = ((long long)(b * T + tt) * S + s) * C + cc;
    *reinterpret_cast<uint4*>(o + g) = *reinterpret_cast<const uint4*>(sQ + tt * C + cc);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int C,
           int heads, float scale, cudaStream_t stream) {
  const int smem = 3 * T * C * 2;
  cudaFuncSetAttribute(temporal_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid(S, B);
  temporal_attn_kernel<DH><<<grid, 32 * heads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), T, S, C, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (B, T, S, C) bf16, C = heads * head_dim, T <= 32.
// Returns cudaErrorInvalidValue for a head_dim without an instantiation:
// the head dims that the gate sends here on the shipped encoders (vits m2:
// 8, m0: 24; vitb m2 at 518^2 and the KV warm-up's m2/m3: 16, 8 heads of
// 16 at C = 128, 256 threads and 3 * 32 * 128 * 2 = 24.6 KB of shared
// memory per CTA).
extern "C" int vda_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int T, int S, int C, int heads, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 8: return launch<8>(q, k, v, o, B, T, S, C, heads, scale, st);
    case 16: return launch<16>(q, k, v, o, B, T, S, C, heads, scale, st);
    case 24: return launch<24>(q, k, v, o, B, T, S, C, heads, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
