// Kernel B on fp32 operands: the motion modules' temporal attention core
// under --fp32.
//
// Replaces video_depth_anything_tpu/ops/pallas_temporal.py:_temporal_kernel
// (via temporal_attention_window) where the JAX package runs it on fp32
// inputs: its gate checks no dtype ("bf16/f32") and its body computes in the
// input dtype, so the probabilities stay fp32.  For every (batch, location,
// head) of (B, T, S, C) fp32 tensors: scores q_t . k_t' * scale over the
// head dim d = C / heads, an fp32 softmax over the T <= 32 key frames, and
// sum_t' p . v_t', all FFMA in fp32.  d in {8, 16, 24, 32, 48, 128}, as the
// bf16 kernel.
//
// Bound on the H100: bytes.  4 * B * S * C * T^2 FLOP against 16 * B * T *
// S * C bytes (q, k, v read once, out written once, 4 bytes each): T / 4 =
// 8 FLOP a byte, below the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s,
// 20 FLOP a byte), so the least time is the bytes over 3.35 TB/s.
//
// Design (a simple kernel that is right; speed is later work).
// - A CTA is one tile of ops/temporal_attention.tile_plan reckoned at
//   4-byte elements: L adjacent locations x G whole heads (at most 128
//   channels: 512-byte runs a frame), all T frames of q, k and v.  It loads
//   the tile with coalesced 16-byte loads into shared rows of L * G * d + 4
//   floats, one row per frame (the pad keeps the 16-byte reads of 8
//   frames in 8 bank groups), and has no pipeline: load, compute, store.
// - One thread per (query frame, location, head): 32 * L * G threads, the
//   lanes of a warp the 32 query frames of one (location, head), so every
//   key and value read is a broadcast.  Its T scores sit in registers; the
//   softmax is exact (max, exp2, sum); keys at or past T are never read.
// - The output overwrites the thread's own q row in shared memory (no other
//   thread reads it); after a barrier the tile goes out with coalesced
//   16-byte stores, locations past S skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int T, S, C, L, G, hgroups, sblocks;
  float scale_log2;
};

template <int D>
__global__ void temporal_f32(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int W = p.G * D;       // channels of a tile
  const int rs = p.L * W + 4;  // floats of a shared row (one frame)
  float* qs = smem;
  float* ks = smem + kT * rs;
  float* vs = smem + 2 * kT * rs;
  const int T = p.T;

  int tile = blockIdx.x;
  const int hg = tile % p.hgroups;
  tile /= p.hgroups;
  const int sb = tile % p.sblocks;
  const int b = tile / p.sblocks;
  const int s0 = sb * p.L, c0 = hg * W;

  // coalesced 16-byte loads of q, k, v: frame t, location l, channel w
  const int w4 = W / 4, per_frame = p.L * w4;
  for (int i = threadIdx.x; i < T * per_frame; i += blockDim.x) {
    const int t = i / per_frame, r = i % per_frame;
    const int l = r / w4, w = (r % w4) * 4;
    const int s = s0 + l;
    const int dst = t * rs + l * W + w;
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), kx = qx, vx = qx;
    if (s < p.S) {
      const long long src = ((long long)(b * T + t) * p.S + s) * p.C + c0 + w;
      qx = *reinterpret_cast<const float4*>(p.q + src);
      kx = *reinterpret_cast<const float4*>(p.k + src);
      vx = *reinterpret_cast<const float4*>(p.v + src);
    }
    *reinterpret_cast<float4*>(qs + dst) = qx;
    *reinterpret_cast<float4*>(ks + dst) = kx;
    *reinterpret_cast<float4*>(vs + dst) = vx;
  }
  __syncthreads();

  const int t = threadIdx.x % kT, unit = threadIdx.x / kT;
  const int col = (unit / p.G) * W + (unit % p.G) * D;  // (location, head) column
  if (t < T) {
    float* qrow = qs + t * rs + col;
    float s[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      const float4 qx = *reinterpret_cast<const float4*>(qrow + e);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (j < T) {
          const float4 kx = *reinterpret_cast<const float4*>(ks + j * rs + col + e);
          s[j] = fmaf(qx.x, kx.x, s[j]);
          s[j] = fmaf(qx.y, kx.y, s[j]);
          s[j] = fmaf(qx.z, kx.z, s[j]);
          s[j] = fmaf(qx.w, kx.w, s[j]);
        }
      }
    }
    float m = s[0] * p.scale_log2;
#pragma unroll
    for (int j = 1; j < kT; ++j)
      if (j < T) m = fmaxf(m, s[j] * p.scale_log2);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      s[j] = j < T ? exp2f(s[j] * p.scale_log2 - m) : 0.f;
      l += s[j];
    }
    const float inv = 1.f / l;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (j < T) {
          const float4 vx = *reinterpret_cast<const float4*>(vs + j * rs + col + e);
          acc.x = fmaf(s[j], vx.x, acc.x);
          acc.y = fmaf(s[j], vx.y, acc.y);
          acc.z = fmaf(s[j], vx.z, acc.z);
          acc.w = fmaf(s[j], vx.w, acc.w);
        }
      }
      *reinterpret_cast<float4*>(qrow + e) =
          make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < T * per_frame; i += blockDim.x) {
    const int t2 = i / per_frame, r = i % per_frame;
    const int l = r / w4, w = (r % w4) * 4;
    const int s = s0 + l;
    if (s >= p.S) continue;
    const long long dst = ((long long)(b * T + t2) * p.S + s) * p.C + c0 + w;
    *reinterpret_cast<float4*>(p.o + dst) =
        *reinterpret_cast<const float4*>(qs + t2 * rs + l * W + w);
  }
}

template <int D>
int dispatch(const Params& p, int tiles, cudaStream_t st) {
  const int threads = kT * p.L * p.G;
  const int smem = 3 * kT * (p.L * p.G * D + 4) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(temporal_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_f32<D><<<tiles, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vda_temporal_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          int B, int T, int S, int C, int heads, float scale,
                                          int locs, int group, void* stream) {
  if (heads <= 0 || C % heads || T < 1 || T > kT || locs < 1 || group < 1 || heads % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / heads;
  if (kT * locs * group > 1024) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.T = T;
  p.S = S;
  p.C = C;
  p.L = locs;
  p.G = group;
  p.hgroups = heads / group;
  p.sblocks = (S + locs - 1) / locs;
  p.scale_log2 = scale * 1.4426950408889634f;
  const long long tiles = (long long)B * p.sblocks * p.hgroups;
  if (tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return dispatch<8>(p, static_cast<int>(tiles), st);
    case 16: return dispatch<16>(p, static_cast<int>(tiles), st);
    case 24: return dispatch<24>(p, static_cast<int>(tiles), st);
    case 32: return dispatch<32>(p, static_cast<int>(tiles), st);
    case 48: return dispatch<48>(p, static_cast<int>(tiles), st);
    case 128: return dispatch<128>(p, static_cast<int>(tiles), st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
