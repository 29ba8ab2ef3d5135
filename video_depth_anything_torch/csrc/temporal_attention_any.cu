// Kernel B in bf16 at every head width its JAX gate admits beyond the six
// that csrc/temporal_attention.cu instantiates: the head width d = C /
// heads known only at run time (vda_temporal_attention_any; the fp32
// counterpart is csrc/temporal_attention_any_f32.cu).  The source stays
// templated on the element type E, instantiated for bf16 only.
//
// Replaces video_depth_anything_tpu/ops/pallas_temporal.py:_temporal_kernel
// (via temporal_attention_window) where the gate (try_temporal_attention)
// admits a (C, heads) outside {8, 16, 24, 32, 48, 128} x C <= 1024: with
// location packing any d whose packed width is 128-aligned (d = 1 ... 7, 10,
// 12, 14, 20, 28, 40, 56, 64, 80, 96, 112 at 4, 8 or 16 heads; up to d = 512
// at one head), without it d = 64 at C = 128 ... 1024 and d = 128 at C =
// 2048.  It computes what the instantiated kernel computes, with its
// numerics: fp32 scores q_t . k_t' over d, the exp2 softmax over the T <=
// 32 key frames (keys at or past T never read), the probabilities rounded
// to bf16, sum_t' p . v_t' in fp32, the out in bf16.
//
// Bound on the H100: bytes (T / 2 = 16 FLOP a byte at T = 32), except at d
// <= 3, where the softmax's exponentials (16 a clock an SM) take longer.
//
// Design.  The instantiated kernels' tile walk (ops/temporal_attention.
// tile_plan: L adjacent locations x G whole heads of the natural (B, T, S,
// C) layout, all T frames), without their producer warp and ring: a CTA
// walks tiles t = blockIdx.x, t + gridDim.x, ...; for each, every warp
// copies runs of contiguous elements into shared rows of fp32 (bf16
// converted on the way), one row a (tensor, frame), heads at their natural
// offsets h d (no padding, so no alignment asked of d): one run a (tensor,
// frame) of L C elements where the tile holds every head, else one a
// (tensor, frame, location) of G d.  Then KL adjacent threads take a
// (location, head, query frame) unit, query frame fastest: each its share
// of the head's columns (every KL-th chunk of V), the frame's partial
// scores over the key rows in 32 registers, summed over the KL lanes by xor
// shuffles, the softmax (on every lane), and P V over its own columns, read
// from shared memory V elements at a time (V = 4, 2 or 1: the largest that
// divides d, a template parameter), the out written over the unit's own q
// columns; after a barrier the tile goes out in runs again.  KL (1, 2, 4 or
// 8, at most d / V) spreads a tile's units over the CTA's 256 threads: a
// tile of one location and two heads of 96 has 64 units.  A row stride ld
// with ld / V odd keeps a warp's V-wide reads of 32 query rows on distinct
// banks; the key and value reads of one unit group are broadcasts.
// CUDA-core FMAs: mma.sync needs d in steps of 8 columns, which a head of d
// = 3 at offset 3 h does not give.
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 32;          // frames a tile holds at most (T <= 32)
constexpr int kThreads = 256;   // eight warps
constexpr int kSmemMax = 227 * 1024;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, T, S, C, d;
  int L, G;        // locations and heads per tile
  int cg;          // G * d: a tile's channels at one location
  int ld;          // shared row stride, floats
  int kl;          // lanes a unit
  int vec;         // runs copied 16 bytes of global memory at a time
  int sblocks, hgroups, tiles;
  float scale_log2;  // d^-0.5 * log2(e)
};

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes of global memory (8 bf16) to / from floats in shared memory
// (16-byte aligned)
__device__ __forceinline__ void copy16_in(float* dst, const bf16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const bf162* h = reinterpret_cast<const bf162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void copy16_out(bf16* dst, const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  uint4 u;
  u.x = pack_bf16x2(a.x, a.y), u.y = pack_bf16x2(a.z, a.w);
  u.z = pack_bf16x2(b.x, b.y), u.w = pack_bf16x2(b.z, b.w);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void decode(const Params& p, int tile, int& b, int& s0, int& c0,
                                       int& lv) {
  const int hg = tile % p.hgroups, r = tile / p.hgroups;
  const int sb = r % p.sblocks;
  b = r / p.sblocks;
  s0 = sb * p.L;
  c0 = hg * p.cg;
  lv = min(p.L, p.S - s0);
}

// One unit: query frame t of the head whose columns start at `col`, in the
// shared rows at `sm` (q, k, v: T rows of ld floats each, from row 0, T,
// 2T), lane `sub` of its kl; the lane's out overwrites the q columns it
// read.  Every lane of the warp calls it (the shuffles); `store` says
// whether this lane's unit exists.
template <typename E, int V>
__device__ __forceinline__ void attend(float* sm, int ld, int nT, int d, int col, int t,
                                       float sl2, int sub, int kl, bool store) {
  float* sq = sm + t * ld + col;
  const float* sk = sm + nT * ld + col;
  const float* sv = sm + 2 * nT * ld + col;
  float s[kT];
#pragma unroll
  for (int f = 0; f < kT; ++f) s[f] = 0.f;
#pragma unroll 1
  for (int e = sub * V; e < d; e += kl * V) {
    Vec<V> qv;
    qv.load(sq + e);
#pragma unroll
    for (int f = 0; f < kT; ++f) {
      if (f < nT) {
        Vec<V> kv;
        kv.load(sk + f * ld + e);
#pragma unroll
        for (int i = 0; i < V; ++i) s[f] = fmaf(qv.x[i], kv.x[i], s[f]);
      }
    }
  }
  for (int r = 1; r < kl; r <<= 1) {
#pragma unroll
    for (int f = 0; f < kT; ++f) s[f] += __shfl_xor_sync(0xffffffffu, s[f], r);
  }
  float mx = -INFINITY;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    s[f] = f < nT ? s[f] * sl2 : -INFINITY;
    mx = fmaxf(mx, s[f]);
  }
  float sum = 0.f;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    s[f] = f < nT ? exp2_approx(s[f] - mx) : 0.f;
    sum += s[f];
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int f = 0; f < kT; ++f) s[f] = sizeof(E) == 2 ? bf16_round(s[f] * inv) : s[f] * inv;
  if (!store) return;
#pragma unroll 1
  for (int e = sub * V; e < d; e += kl * V) {
    Vec<V> acc;
#pragma unroll
    for (int i = 0; i < V; ++i) acc.x[i] = 0.f;
#pragma unroll
    for (int f = 0; f < kT; ++f) {
      if (f < nT) {
        Vec<V> vv;
        vv.load(sv + f * ld + e);
#pragma unroll
        for (int i = 0; i < V; ++i) acc.x[i] = fmaf(s[f], vv.x[i], acc.x[i]);
      }
    }
    acc.store(sq + e);  // q columns that only this lane read
  }
}

// STOP: the copies in and out alone (attend dropped, out = q): the split
// that ops/temporal_attention.temporal_attention_split times.
template <typename E, int V, bool STOP>
__global__ void __launch_bounds__(kThreads) temporal_any(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const E* src[3] = {static_cast<const E*>(p.q), static_cast<const E*>(p.k),
                     static_cast<const E*>(p.v)};
  E* out = static_cast<E*>(p.o);
  constexpr int W = 16 / sizeof(E);  // elements of a 16-byte copy
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int b, s0, c0, lv;
    decode(p, tile, b, s0, c0, lv);
    // runs in: one warp a run, every location's channels at once where the
    // tile holds every head (they are adjacent in memory, as in the row)
    const int nl = p.cg == p.C ? 1 : lv, len = p.cg == p.C ? lv * p.C : p.cg;
    for (int r = warp; r < 3 * p.T * nl; r += kThreads / 32) {
      const int l = r % nl, xt = r / nl, x = xt / p.T, t = xt - x * p.T;
      const E* g = src[x] + ((long long)(b * p.T + t) * p.S + s0 + l) * p.C + c0;
      float* dst = sm + (x * p.T + t) * p.ld + l * p.cg;
      if (p.vec) {
        for (int e = lane * W; e < len; e += 32 * W) copy16_in(dst + e, g + e);
      } else {
#pragma unroll 4
        for (int e = lane; e < len; e += 32) dst[e] = to_f(g[e]);
      }
    }
    __syncthreads();
    // (location, head, query frame) units, frame fastest, kl lanes each; every
    // lane runs the same number of rounds (the shuffles need the whole warp)
    const int units = lv * p.G * p.T, per = kThreads / p.kl;
    const int sub = threadIdx.x % p.kl, first = threadIdx.x / p.kl;
    for (int u = first; !STOP && u - first < units; u += per) {
      const int uu = min(u, units - 1), t = uu % p.T, lh = uu / p.T;
      attend<E, V>(sm, p.ld, p.T, p.d, (lh / p.G) * p.cg + (lh % p.G) * p.d, t, p.scale_log2,
                   sub, p.kl, u < units);
    }
    __syncthreads();
    // runs out: the q rows, now the out
    for (int r = warp; r < p.T * nl; r += kThreads / 32) {
      const int l = r % nl, t = r / nl;
      E* g = out + ((long long)(b * p.T + t) * p.S + s0 + l) * p.C + c0;
      const float* srow = sm + t * p.ld + l * p.cg;
      if (p.vec) {
        for (int e = lane * W; e < len; e += 32 * W) copy16_out(g + e, srow + e);
      } else {
#pragma unroll 4
        for (int e = lane; e < len; e += 32) from_f(g + e, srow[e]);
      }
    }
    __syncthreads();  // the rows are free for the next tile
  }
}

template <typename E, int V, bool STOP>
int launch(Params p, cudaStream_t stream) {
  auto kern = temporal_any<E, V, STOP>;
  static bool configured = false;
  static int sms = 0;
  if (!configured) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    configured = true;
  }
  const int smem = 3 * p.T * p.ld * 4;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  per_sm = std::max(1, per_sm);
  const int grid = std::min(p.tiles, per_sm * sms);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool STOP = false>
int run(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int C,
        int heads, float scale, int locs, int group, void* stream) {
  if (heads <= 0 || C % heads || T < 1 || T > kT || locs < 1 || group < 1 || heads % group)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.T = T;
  p.S = S;
  p.C = C;
  p.d = C / heads;
  p.L = locs;
  p.G = group;
  p.cg = group * p.d;
  const int V = p.d % 4 == 0 ? 4 : p.d % 2 == 0 ? 2 : 1;
  const int base = locs * p.cg;  // a multiple of V
  p.ld = (base / V) % 2 ? base : base + V;
  // 16-byte copies where every run starts on and spans whole 16-byte chunks
  // of global memory and lands on 16-byte aligned shared memory
  const int w = 16 / static_cast<int>(sizeof(E));
  p.vec = C % w == 0 && p.cg % w == 0 && p.ld % 4 == 0 && p.cg % 4 == 0;
  p.kl = 1;  // lanes a unit: up to 8, each with a chunk, while the tile's units fill the CTA
  while (p.kl < 8 && 2 * p.kl * V <= p.d && 2 * p.kl * locs * group * T <= kThreads) p.kl *= 2;
  p.sblocks = (S + locs - 1) / locs;
  p.hgroups = heads / group;
  p.tiles = B * p.sblocks * p.hgroups;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return V == 4 ? launch<E, 4, STOP>(p, st)
                : V == 2 ? launch<E, 2, STOP>(p, st) : launch<E, 1, STOP>(p, st);
}

}  // namespace

// q, k, v, o: contiguous (B, T, S, C) bf16, C = heads * d, 1 <= T <= 32,
// any d.  A tile holds `locs` adjacent locations x `group` whole heads
// (group divides heads): ops/temporal_attention.tile_plan for 2-byte
// elements.  Returns cudaErrorInvalidValue for a tile whose rows do not fit
// in shared memory (3 T ld floats, ld = locs group d rounded as above).
extern "C" int vda_temporal_attention_any(const void* q, const void* k, const void* v, void* o,
                                          int B, int T, int S, int C, int heads, float scale,
                                          int locs, int group, void* stream) {
  return run<bf16>(q, k, v, o, B, T, S, C, heads, scale, locs, group, stream);
}

// The copies alone (the split): the same arguments, out = q.
extern "C" int vda_temporal_attention_any_split(const void* q, const void* k, const void* v,
                                                void* o, int B, int T, int S, int C, int heads,
                                                float scale, int locs, int group, void* stream) {
  return run<bf16, true>(q, k, v, o, B, T, S, C, heads, scale, locs, group, stream);
}
