// Kernel A on fp32 operands: flash-attention forward for the ViT's spatial
// attention under --fp32.
//
// Replaces the same TPU kernels as flash_attention.cu
// (video_depth_anything_tpu/ops/pallas_attention.py: _flash_kernel_native,
// _flash_kernel, _flash_kernel_fast, _flash_kernel_single) where the JAX
// package runs them on fp32 inputs: their gates check no dtype and their
// bodies compute in the input dtype, so p stays fp32 (it is cast to
// v.dtype) and both products are fp32 products.  Here they are FFMA on the
// CUDA cores in fp32; nothing is rounded to bf16 or TF32.  Same domain as
// the bf16 kernel: D = 64 and 192, any head count, exact or FAST, q, k and
// v read through (batch, token, head) strides (the fused qkv projection's
// views), any N.  Forward only: no JAX entry point trains in fp32.
//
// Bound on the H100: operations.  4 * N^2 * D * H * B FLOP on the CUDA
// cores' fp32 FMA (67 TFLOP/s); at vits 518x518 (B*T = 32, N = 1370, H = 6)
// that is 9.2e10 FLOP, 1.4 ms, against 67 MB of traffic (0.02 ms).
//
// Design (a simple kernel that is right; speed is later work).
// - A CTA is 256 threads over one (b, h) and BQ query rows: P threads a
//   row (P = 2 at D = 64, 4 at D = 192, so BQ = 128 and 64), each holding
//   DP = D / P dims of the row's q (pre-scaled by scale * log2 e, so the
//   scores come out in the exp2 domain) and of its output accumulator in
//   registers.  The P threads of a row are adjacent lanes; a score's P
//   partial dot products are summed by xor shuffles inside the group.
// - K and V run through shared memory in tiles of KT = 32 keys, loaded
//   with 16-byte loads (rows past N zero-filled), stored as [key][panel]
//   [DP + 4]: the 4-float pad puts the P panels a lane group reads at one
//   key in different bank groups, and every lane with the same panel reads
//   the same address (a broadcast).
// - Online softmax in fp32 per tile: running max m, rescale by
//   exp2(m_old - m_new), p = exp2(s - m), l += sum p, o = o * alpha + p V.
//   FAST keeps m = 0 and never rescales (the JAX ':fast' contract: exact
//   while the scaled logits stay inside fp32's exp2 domain, about +-88).
//   Keys at or past N score -inf (p = 0).  Rows past N compute on zero q
//   and are never stored.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 32;  // keys per shared-memory tile

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int n, heads;
  long long st[12];  // (b, n, h) element strides of q, k, v, o
  float scale_log2;
};

template <int D, int P, bool FAST>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Args a) {
  constexpr int DP = D / P;      // dims a thread holds
  constexpr int BQ = kThreads / P;  // query rows a CTA
  constexpr int RS = DP + 4;     // padded panel stride in shared memory
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [kKeys][P][RS]
  float* vs = smem + kKeys * P * RS;   // [kKeys][P][RS]

  const int tid = threadIdx.x;
  const int row = tid / P, panel = tid % P;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * BQ + row;
  const int n = a.n;

  float q[DP], acc[DP];
  {
    const float* src = a.q + b * a.st[0] + (long long)qi * a.st[1] + h * a.st[2] + panel * DP;
#pragma unroll
    for (int e = 0; e < DP; e += 4) {
      float4 x = qi < n ? *reinterpret_cast<const float4*>(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      q[e] = x.x * a.scale_log2;
      q[e + 1] = x.y * a.scale_log2;
      q[e + 2] = x.z * a.scale_log2;
      q[e + 3] = x.w * a.scale_log2;
    }
  }
#pragma unroll
  for (int e = 0; e < DP; ++e) acc[e] = 0.f;
  float m = FAST ? 0.f : -CUDART_INF_F, l = 0.f;

  const float* kbase = a.k + b * a.st[3] + h * a.st[5];
  const float* vbase = a.v + b * a.st[6] + h * a.st[8];
  for (int k0 = 0; k0 < n; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKeys * D / 4; i += kThreads) {
      const int j = i / (D / 4), e = (i % (D / 4)) * 4;
      const int key = k0 + j;
      const int dst = (j * P + e / DP) * RS + e % DP;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < n) {
        kx = *reinterpret_cast<const float4*>(kbase + (long long)key * a.st[4] + e);
        vx = *reinterpret_cast<const float4*>(vbase + (long long)key * a.st[7] + e);
      }
      *reinterpret_cast<float4*>(ks + dst) = kx;
      *reinterpret_cast<float4*>(vs + dst) = vx;
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float* kr = ks + (j * P + panel) * RS;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < DP; e += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + e);
        sum = fmaf(q[e], kx.x, sum);
        sum = fmaf(q[e + 1], kx.y, sum);
        sum = fmaf(q[e + 2], kx.z, sum);
        sum = fmaf(q[e + 3], kx.w, sum);
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s[j] = k0 + j < n ? sum : -CUDART_INF_F;
    }
    if (!FAST) {
      float mt = m;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) mt = fmaxf(mt, s[j]);
      const float alpha = exp2f(m - mt);
      m = mt;
      l *= alpha;
#pragma unroll
      for (int e = 0; e < DP; ++e) acc[e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = exp2f(s[j] - m);
      l += p;
      const float* vr = vs + (j * P + panel) * RS;
#pragma unroll
      for (int e = 0; e < DP; e += 4) {
        const float4 vx = *reinterpret_cast<const float4*>(vr + e);
        acc[e] = fmaf(p, vx.x, acc[e]);
        acc[e + 1] = fmaf(p, vx.y, acc[e + 1]);
        acc[e + 2] = fmaf(p, vx.z, acc[e + 2]);
        acc[e + 3] = fmaf(p, vx.w, acc[e + 3]);
      }
    }
  }
  if (qi >= n) return;
  const float inv = 1.f / l;
  float* dst = a.o + b * a.st[9] + (long long)qi * a.st[10] + h * a.st[11] + panel * DP;
#pragma unroll
  for (int e = 0; e < DP; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(acc[e] * inv, acc[e + 1] * inv, acc[e + 2] * inv, acc[e + 3] * inv);
}

template <int D, int P, bool FAST>
int launch(const Args& a, int batch, cudaStream_t s) {
  constexpr int BQ = kThreads / P;
  const int smem = 2 * kKeys * P * (D / P + 4) * static_cast<int>(sizeof(float));
  auto kern = flash_fwd_f32<D, P, FAST>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.n + BQ - 1) / BQ, a.heads, batch);
  kern<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vda_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.n = n;
  a.heads = heads;
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  for (int i = 0; i < 12; ++i) a.st[i] = st[i];
  a.scale_log2 = scale * 1.4426950408889634f;
  if (batch <= 0 || n <= 0 || heads <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return fast ? launch<64, 2, true>(a, batch, s) : launch<64, 2, false>(a, batch, s);
  if (head_dim == 192)
    return fast ? launch<192, 4, true>(a, batch, s) : launch<192, 4, false>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
