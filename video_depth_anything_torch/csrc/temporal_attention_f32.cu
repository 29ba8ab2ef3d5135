// Kernel B on fp32 operands: the motion modules' temporal attention core
// under --fp32.
//
// Replaces video_depth_anything_tpu/ops/pallas_temporal.py:_temporal_kernel
// (via temporal_attention_window) where the JAX package runs it on fp32
// inputs: its gate checks no dtype ("bf16/f32") and its body computes in the
// input dtype, so the probabilities stay fp32.  For every (batch, location,
// head) of (B, T, S, C) fp32 tensors: scores q_t . k_t' * scale over the
// head dim d = C / heads, an exact fp32 softmax over the T <= 32 key frames,
// and sum_t' p . v_t', all FFMA in fp32.  d in {8, 16, 24, 32, 48, 128}, as
// the bf16 kernel.
//
// Bound on the H100: bytes.  4 * B * S * C * T^2 FLOP against 16 * B * T *
// S * C bytes (q, k, v read once, out written once, 4 bytes each): T / 4 =
// 8 FLOP a byte, below the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s,
// 20 FLOP a byte), so the least time is the bytes over 3.35 TB/s, and FFMA
// products keep up with the bytes when they are fed from registers: the
// tensor cores (3xTF32 to stay fp32-accurate) are not needed.
//
// Design: the bf16 kernel's skeleton (temporal_hopper<d>) at 4-byte
// elements.
// - A persistent, pipelined walk.  Resident CTAs walk tiles of
//   ops/temporal_attention.tile_plan at 4-byte elements: L adjacent
//   locations x G whole heads, at most W = 128 channels (512-byte runs a
//   frame), all T frames.  A producer thread fills a ring (Plan below:
//   two stages of about 50 KB and two CTAs an SM, or four stages and one
//   CTA at d <= 16) with one TMA tensor copy per tensor and tile, on an
//   mbarrier with the tile's byte count: a box of W + 4 floats x T frames
//   of a 3-D map (S * C, T, B) of the tensor, starting at the tile's first
//   channel (a tile's locations are adjacent only when it holds every
//   head, L = 128 / C; a head group's tile has one location; where those
//   tiles would not cover the SMs, one location a tile).  A bulk copy per
//   (tensor, frame[, location]) run, as the bf16 kernel makes them (96 a
//   tile at T = 32), would hold this kernel to the copy engine's rate
//   (31-75 ns a 384- or 512-byte copy on an H100: 1.5-2.9x the bytes
//   bound).  The next tiles' q, k and v are in flight while the current
//   one computes.  The box
//   lands as shared rows of W + 4 floats, one per frame (the 4 extra
//   floats are the next channels, or zeros past the end, never read): an
//   odd number of 16-byte chunks, so 16-byte reads of 8 adjacent frames
//   hit 8 bank groups.
// - Consumer warps take units: (location, head, QF query frames), QF = 32
//   up to d = 32, 16 at d = 48 and 8 at d = 128, so that every shipped
//   width's 128-channel tile keeps four consumer warps busy (one unit a
//   tile at d = 128 and C = 1024 would otherwise leave one warp a CTA).
//   KL lanes share a query row (4, or 8 at d = 128; unit_frames and
//   row_lanes below): lane (a, c) = (lane / KL, lane % KL) holds the
//   scores of query frames a + (32 / KL) i against key frames c + KL j in
//   registers, so each 16-byte read of q or k feeds several FMAs, and the
//   frames of one read are adjacent rows.  A row's softmax reduces across
//   its KL lanes by xor shuffles; keys at or past T score -inf (their
//   stage rows are never loaded); v's rows past T are zeroed once, so that
//   their probability 0 meets finite values.
// - P V in passes of DC columns: each lane sums its own keys, a
//   reduce-scatter over the row's lanes leaves lane c DC / KL of the
//   pass's columns, which it stores straight to global memory (DC
//   contiguous floats a frame and warp store).  The stage goes back to the
//   producer after each consumer thread's last read of it.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 32;  // frame rows per stage (T <= 32)
constexpr int kSmemMax = 227 * 1024;

// Consumer warps, ring stages and CTAs an SM: at d <= 16 one CTA of eight
// consumer warps and four stages (a tile's 8 or 16 units over 8 warps: half
// the latency a tile of four warps takes, which small batches see), else
// two CTAs of four warps and two stages (about 99 KB each); eight consumer
// warps an SM either way.
template <int D>
struct Plan {
  static constexpr int NW = D <= 16 ? 8 : 4;
  static constexpr int STAGES = D <= 16 ? 4 : 2;
  static constexpr int CTAS = D <= 16 ? 1 : 2;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, T, S, C;
  int L, G;          // locations and heads per tile
  int ld;            // shared row stride, floats: L * G * d + 4
  int nw;            // consumer warps
  int sblocks, hgroups, tiles;
  float scale_log2;  // d^-0.5 * log2(e)
};

// A unit's query frames (QF), the lanes that share a query row (KL: the
// row's 32 keys c + KL j, j < 32 / KL, spread over them), and so a lane's
// query frames QI = QF * KL / 32 and the columns of one P V pass, DC = 32 /
// QI (32 accumulators a lane).  KL = 8 at d = 128: a lane reads 2 q rows
// and 4 k rows for the 32 FMAs of a 4-float chunk, not 1 and 8, and 4 v
// float4 for 32 P V FMAs, not 8: shared memory's 128 bytes a clock to the
// lanes bound that width at KL = 4.
__host__ __device__ constexpr int unit_frames(int d) { return d <= 32 ? 32 : d <= 64 ? 16 : 8; }
__host__ __device__ constexpr int row_lanes(int d) { return d <= 64 ? 4 : 8; }
__host__ __device__ constexpr int lane_frames(int d) { return unit_frames(d) * row_lanes(d) / 32; }
__host__ __device__ constexpr int pass_cols(int d) { return 32 / lane_frames(d); }

__device__ __forceinline__ void decode(const Params& p, int tile, int cg, int& b, int& s0, int& c0,
                                       int& lv) {
  const int hg = tile % p.hgroups, r = tile / p.hgroups;
  const int sb = r % p.sblocks;
  b = r / p.sblocks;
  s0 = sb * p.L;
  c0 = hg * cg;
  lv = min(p.L, p.S - s0);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One unit: query frames f0 .. f0 + QF - 1 of the head whose columns start
// at `col` of the stage at `base` (q, k, v: kT rows of ld floats each); the
// output goes to `out` (frame t at out + t * frame_stride).
template <int D>
__device__ __forceinline__ void attend(const float* base, int ld, int col, int f0, int T,
                                       float sl2, int lane, float* out, long long frame_stride) {
  constexpr int KL = row_lanes(D), QL = 32 / KL, KJ = 32 / KL;  // lanes a row, rows, keys a lane
  constexpr int QI = lane_frames(D);  // query frames a lane
  constexpr int DC = pass_cols(D), DQ = DC / KL;
  constexpr int ROUNDS = KL == 8 ? 3 : 2;  // log2(KL)
  const float* sq = base + col;
  const float* sk = base + kT * ld + col;
  const float* sv = base + 2 * kT * ld + col;
  const int a = lane / KL, c = lane % KL;

  float s[QI][KJ];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
  // Every row and key is computed, T or not (a guard on T inside these
  // loops cost more than it saved, even at T = 17): the scores of keys at or
  // past T are masked and rows at or past T never stored.
#pragma unroll 2
  for (int e = 0; e < D; e += 4) {
    float4 qv[QI];
#pragma unroll
    for (int i = 0; i < QI; ++i) qv[i] = lds4(sq + (f0 + a + QL * i) * ld + e);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const float4 kv = lds4(sk + (c + KL * j) * ld + e);
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
      }
    }
  }

  // exact softmax over the key frames c + KL j, reduced across the row's
  // lanes; scale * log2(e) folded into the exp2's FMA
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      if (c + KL * j >= T) s[i][j] = -INFINITY;
      m = fmaxf(m, s[i][j]);
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1 << r));
    const float ms = m * sl2;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      s[i][j] = exp2_approx(fmaf(s[i][j], sl2, -ms));
      l += s[i][j];
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) l += __shfl_xor_sync(0xffffffffu, l, 1 << r);
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] *= inv;
  }

  // P V in passes of DC columns: each lane sums its own keys, then a
  // reduce-scatter over the row's lanes (xor 1, 2, 4: round r keeps the
  // half that bit r of c picks) leaves it DQ columns at `part`
  int part = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) part += (c >> r & 1) * (DC >> (r + 1));
#pragma unroll 1
  for (int dc0 = 0; dc0 < D; dc0 += DC) {
    float o[QI][DC];
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int x = 0; x < DC; ++x) o[i][x] = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
#pragma unroll
      for (int m4 = 0; m4 < DC / 4; ++m4) {
        const float4 vv = lds4(sv + (c + KL * j) * ld + dc0 + 4 * m4);
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          o[i][4 * m4] = fmaf(s[i][j], vv.x, o[i][4 * m4]);
          o[i][4 * m4 + 1] = fmaf(s[i][j], vv.y, o[i][4 * m4 + 1]);
          o[i][4 * m4 + 2] = fmaf(s[i][j], vv.z, o[i][4 * m4 + 2]);
          o[i][4 * m4 + 3] = fmaf(s[i][j], vv.w, o[i][4 * m4 + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      scatter_round<DC / 2, 0>(o[i], c);
      scatter_round<DC / 4, 1>(o[i], c);
      if constexpr (ROUNDS == 3) scatter_round<DC / 8, 2>(o[i], c);
      const int t = f0 + a + QL * i;
      if (t < T) {
        float* dst = out + t * frame_stride + dc0 + part;
        if constexpr (DQ == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(o[i][0], o[i][1]);
        } else {
#pragma unroll
          for (int x = 0; x < DQ; x += 4)
            *reinterpret_cast<float4*>(dst + x) =
                make_float4(o[i][x], o[i][x + 1], o[i][x + 2], o[i][x + 3]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * (Plan<D>::NW + 1), Plan<D>::CTAS) temporal_f32(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int kStages = Plan<D>::STAGES, kBarBytes = Plan<D>::BAR_BYTES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  // the ring at the first 128-byte boundary past the barriers (TMA's destinations)
  const uint32_t pad = (128u - (smem_u32(smem_raw + kBarBytes) & 127u)) & 127u;
  float* ring = reinterpret_cast<float*>(smem_raw + kBarBytes + pad);
  const int stage_floats = 3 * kT * p.ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthr = p.nw * 32;  // consumer threads
  const int cg = p.G * D;

  // v's rows past T are never loaded: zero them once, so that the masked
  // keys (probability 0) meet finite v rows.  Rows past T of q and k feed
  // only masked scores and rows that are never stored.
  if (threadIdx.x == 0) {  // the three tensor maps, ahead of the first copies
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  const int zrow = p.ld / 4, zrows = (kT - p.T) * zrow;
  for (int i = threadIdx.x; i < kStages * zrows; i += blockDim.x) {
    const int st = i / zrows, r = i - st * zrows;
    reinterpret_cast<float4*>(ring + st * stage_floats + (2 * kT + p.T) * p.ld)[r] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nthr);
    }
    fence_mbar_init();
  }
  fence_async_smem();  // the zeros before any TMA write
  __syncthreads();

  if (warp == p.nw) {  // the producer warp: one thread, three boxes a tile
    if (lane != 0) return;
    const uint32_t box_bytes = 4u * p.T * p.ld;  // T rows of W + 4 floats
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
      const int st = it % kStages, n = it / kStages;
      if (n > 0) mbar_wait(&empty[st], (n - 1) & 1);
      int b, s0, c0, lv;
      decode(p, tile, cg, b, s0, c0, lv);
      mbar_arrive_expect_tx(&full[st], 3 * box_bytes);
      float* base = ring + st * stage_floats;
      const int col = s0 * p.C + c0;
      tma_load_3d(base, &tq, &full[st], col, 0, b);
      tma_load_3d(base + kT * p.ld, &tk, &full[st], col, 0, b);
      tma_load_3d(base + 2 * kT * p.ld, &tv, &full[st], col, 0, b);
    }
    return;
  }

  constexpr int QF = unit_frames(D), NZ = kT / QF;  // query slabs a head
  const long long frame_stride = (long long)p.S * p.C;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    int b, s0, c0, lv;
    decode(p, tile, cg, b, s0, c0, lv);
    const float* base = ring + st * stage_floats;
    const int units = p.L * p.G * NZ;  // location-major
    for (int u = warp; u < units; u += p.nw) {
      const int l = u / (p.G * NZ);
      if (l >= lv) break;  // past S, as every later unit
      const int h = (u / NZ) % p.G, f0 = (u % NZ) * QF;
      if (f0 >= p.T) continue;
      attend<D>(base, p.ld, l * cg + h * D, f0, p.T, p.scale_log2, lane,
                p.o + ((long long)b * p.T * p.S + s0 + l) * p.C + c0 + h * D, frame_stride);
    }
    mbar_arrive(&empty[st]);  // this thread's last read of the stage is done
  }
}

template <int D>
int launch(Params p, cudaStream_t stream) {
  auto kern = temporal_f32<D>;
  static bool configured = false;
  static int sms = 0;
  if (!configured) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    configured = true;
  }
  if (p.L > 1 && p.tiles < sms) {  // a small batch: one location a tile, twice the tiles
    p.L = 1;
    p.ld = p.G * D + 4;
    p.sblocks = p.S;
    p.tiles = p.B * p.S * p.hgroups;
  }
  const int smem = Plan<D>::BAR_BYTES + 128 + Plan<D>::STAGES * 3 * kT * p.ld * 4;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.nw = std::min(Plan<D>::NW, p.L * p.G * (kT / unit_frames(D)));
  const int threads = 32 * (p.nw + 1);
  int per_sm = 1;
  // a runtime call before the maps: it makes the context current (make_map)
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  per_sm = std::max(1, per_sm);
  CUtensorMap maps[3];
  const float* src[3] = {p.q, p.k, p.v};
  for (int x = 0; x < 3; ++x)
    if (!make_map_rows_f32(&maps[x], src[x], (long long)p.S * p.C, p.T, p.B, p.ld, p.T))
      return static_cast<int>(cudaErrorInvalidValue);
  const int grid = std::min(p.tiles, per_sm * sms);
  kern<<<grid, threads, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (B, T, S, C) fp32, 16-byte aligned, C = heads * d,
// 1 <= T <= 32.  A tile holds `locs` adjacent locations x `group` whole
// heads (group divides heads): ops/temporal_attention.tile_plan at 4-byte
// elements (where that plan's tiles would not cover the SMs, one location
// a tile).  Returns cudaErrorInvalidValue for a d without an instantiation
// or a tile that does not fit.
extern "C" int vda_temporal_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          int B, int T, int S, int C, int heads, float scale,
                                          int locs, int group, void* stream) {
  if (heads <= 0 || C % heads || T < 1 || T > kT || locs < 1 || group < 1 || heads % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / heads;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.B = B;
  p.T = T;
  p.S = S;
  p.C = C;
  p.L = locs;
  p.G = group;
  p.ld = locs * group * d + 4;
  p.nw = 0;
  p.sblocks = (S + locs - 1) / locs;
  p.hgroups = heads / group;
  p.tiles = B * p.sblocks * p.hgroups;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(p, st);
    case 16: return launch<16>(p, st);
    case 24: return launch<24>(p, st);
    case 32: return launch<32>(p, st);
    case 48: return launch<48>(p, st);
    case 128: return launch<128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
