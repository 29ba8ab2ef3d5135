// Kernel B on fp32 operands at every head width its JAX gate admits beyond
// the six that csrc/temporal_attention_f32.cu instantiates: the head width
// d = C / heads known only at run time (d = 1 ... 7, 10, 12, 14, 20, 28, 40,
// 56, 64, 80, 96, 112 with location packing, up to 512 at one head, 256 at
// two; 64 at C = 128 ... 1024 and 128 at C = 2048 without it).
//
// Replaces video_depth_anything_tpu/ops/pallas_temporal.py:_temporal_kernel
// (via temporal_attention_window) where the JAX package runs it on fp32
// inputs at those widths.  For every (batch, location, head) of (B, T, S, C)
// fp32 tensors: scores q_t . k_t' over d in fp32, the exp2 softmax over the
// T <= 32 key frames (keys at or past T masked), P kept in fp32 and
// sum_t' p . v_t' in fp32, all FFMA.
//
// Bound on the H100: bytes (16 B T S C of them: q, k, v read once, out
// written once; T / 4 = 8 FLOP a byte, under the fp32 CUDA cores' ridge),
// except at d <= 2, where the softmax's B S heads T^2 exponentials take
// longer on the SFU (16 a clock an SM: at T = 32, 1024 exp2 against 512 d
// bytes a (location, head)).  The design computes each exponential once
// (the earlier one-source kernel computed a row's softmax on each of its
// 1-8 lanes), so at d = 1 and 2 the SFU is the floor it works against.
//
// Design: temporal_f32<d>'s skeleton with d a run-time loop bound; the plan
// is ops/temporal_attention.any_f32_plan, which computes the same geometry.
// - A persistent, pipelined walk.  Resident CTAs walk tiles of
//   ops/temporal_attention.tile_plan at 4-byte elements (L adjacent
//   locations x G whole heads, at most 128 channels; one location a tile
//   where those tiles would not cover the SMs).  A tile's row (a frame's
//   L G d floats) lands as nb boxes of bw floats a row, box b from the
//   row's column b w; bw is a multiple of 4 with bw / 4 odd, so 16-byte
//   reads of 8 adjacent frames hit 8 bank groups (the extra floats are the
//   next channels, or zeros past the end, never read).  One box where the
//   row fits a TMA box (256 elements), else ceil(row / 240) boxes (d = 256
//   ... 512, one head a tile).  Ring: slots on full and empty mbarriers.
//   Where a CTA holds two tiles beside a second CTA (or four, with eight
//   consumer warps, where a tile has 8 or more units) a slot is a tile: q,
//   k and v, 32 frame rows of each box.  Else (d >= 160 at one head: a
//   tile's three tensors fill 63-207 KB) a slot is one tensor (SPLIT): a
//   tile takes the ring's next three, a consumer releases q's and k's after
//   its last scores of the tile and v's after its last P V, so that the
//   next tile's q and k load while this one's P V runs; two CTAs of up to
//   four warps where two slots each fit (d <= 384), else one CTA of eight
//   warps (class 4) and as many slots as fit (three at d = 448, 512).
//   Loader "tma": one producer thread issues one 3-D tensor copy (map (S C,
//   T, B)) per box on the slot's full barrier with the slot's byte count.
//   Loader "cp.async", where the frame stride S C 4 bytes or a box's first
//   column is off a 16-byte boundary (a misaligned box start faults as an
//   illegal instruction; C or G d not a multiple of 4: C = 1, 2, 3, 5, 6,
//   7, 10, 14 at one head, 2, 6, 10, 14 at two): the consumer warps copy a
//   tile's rows 4 bytes at a time into its slot, slots - 1 tiles ahead,
//   each thread's copies arriving on the slot's full barrier
//   (cp.async.mbarrier.arrive).
// - Consumers, templated on the width class and the read width V (4, 2 or
//   1: the largest that divides d), not on d (class 0, d <= 4, is one
//   register block a head: instantiated at each of its four widths).
//   Classes 1-3 (d > 4) are temporal_f32's units: (location, head, QF query
//   frames), QF = 32 up to d = 32, 16 up to 64, 8 above; KL = 4 (8 above d
//   = 64) lanes share a query row, lane (a, c) holding the scores of its QI
//   = QF KL / 32 query frames against key frames c + KL j in registers, so
//   each V-wide read of q or k feeds several FMAs; the d loop steps V
//   columns through each box.  Class 4 is class 3's lanes over QF = 4 query
//   frames (eight units a head).  A row's softmax is computed once, reduced
//   across its KL lanes by xor shuffles; P V runs in passes of DC = 32 / QI
//   columns, each lane summing its own keys and a reduce-scatter over the
//   row's lanes leaving lane c DC / KL columns, stored straight to global
//   memory; a last pass narrower than DC is masked.  Class 0 (d <= 4, where
//   the shuffles would outweigh a head's few columns): a lane takes a whole
//   query row (KL = 1: its 32 scores, softmax and P V in registers, no
//   shuffles), and a warp's unit takes 32 / TP (location, head) pairs of TP
//   query frames (TP = 8, 16 or 32, the smallest >= T), so at T <= 16 a unit
//   spans several heads or locations.  Keys at or past T score -inf; v's
//   rows past T are zeroed once (never loaded), so that their probability 0
//   meets finite values; q's rows past T are computed and never stored.
// STOP (the split): the loads and the stores kept, the attention dropped
// (out = q).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 32;             // frame rows a slot holds (T <= 32)
constexpr int kSmemMax = 227 * 1024;
constexpr int kSmSmem = 233472;    // an SM's shared memory, 1 KB of it reserved a CTA
constexpr int kMaxSlots = 12;
constexpr int kBarBytes = 2 * kMaxSlots * 8;
constexpr int kMaxWarps = 8;       // consumer warps of classes 1-4
constexpr int kMaxRowWarps = 16;   // and of class 0
constexpr int kBoxMax = 256;       // a TMA box's elements along one dimension

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, T, S, C, d;
  int L, G, cg;      // locations and heads a tile, cg = G d
  int bw, nb, w;     // box width (the shared row stride, floats), boxes a row, columns
                     // between boxes
  int nw, slots, tma, tp;
  int split;         // a slot a tensor (else a slot a tile: q, k, v at 0, 1, 2 nb boxes)
  int sblocks, hgroups, tiles;
  float scale_log2;  // d^-0.5 * log2(e)
};

// query frames a unit, lanes a query row (class 4: class 3's lanes over
// half its query frames, so that a one-head tile feeds eight warps)
__host__ __device__ constexpr int unit_frames(int kind) {
  return kind == 1 ? 32 : kind == 2 ? 16 : kind == 3 ? 8 : 4;
}
__host__ __device__ constexpr int row_lanes(int kind) { return kind >= 3 ? 8 : 4; }

__device__ __forceinline__ void decode(const Params& p, int tile, int& b, int& s0, int& c0,
                                       int& lv) {
  const int hg = tile % p.hgroups, r = tile / p.hgroups;
  const int sb = r % p.sblocks;
  b = r / p.sblocks;
  s0 = sb * p.L;
  c0 = hg * p.cg;
  lv = min(p.L, p.S - s0);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The arrival of this thread's earlier cp.async copies on `bar` (counted in
// the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The ring of slots: a slot a tile (q, k and v one use, `it`, the CTA's
// tile count), or under `split` a slot a tensor (uses 3 it, 3 it + 1, 3 it
// + 2); use j in slot j % n.  A consumer thread waits for a use's full
// barrier before it arrives on its empty barrier, so that no thread
// arrives for use j + n while another still owes use j its arrival.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  float* base;
  int slot_floats, n;
  __device__ __forceinline__ float* slot(int j) const { return base + (j % n) * slot_floats; }
  __device__ __forceinline__ void wait(int j) const { mbar_wait(&full[j % n], (j / n) & 1); }
  __device__ __forceinline__ void release(int j) const { mbar_arrive(&empty[j % n]); }
};

// The cp.async loader: this consumer thread's share of tensor x's rows of
// a tile, one run of contiguous floats a (frame[, location]) (a tile of
// every head is one run of lv C floats a frame), into the slot at `dst`.
__device__ __forceinline__ void copy_tensor(const Params& p, int tile, int x, float* dst, int warp,
                                            int lane) {
  int b, s0, c0, lv;
  decode(p, tile, b, s0, c0, lv);
  const float* src = x == 0 ? p.q : x == 1 ? p.k : p.v;
  const bool whole = p.cg == p.C;
  const int nl = whole ? 1 : lv, len = whole ? lv * p.C : p.cg;
  for (int r = warp; r < p.T * nl; r += p.nw) {
    const int l = r % nl, t = r / nl;
    const float* g = src + ((long long)(b * p.T + t) * p.S + s0 + l) * p.C + c0;
    float* d = dst + t * p.bw + l * p.cg;
    for (int e = lane; e < len; e += 32) cp_async4(d + e, g + e);
  }
}

// The cp.async loader's copies of the CTA's tile jt (its count) into its
// slot or slots, each slot's earlier use released first.
template <bool SPLIT>
__device__ __forceinline__ void issue_tile(const Params& p, const Ring& ring, int jt, int warp,
                                           int lane) {
  constexpr int U = SPLIT ? 3 : 1;  // slots a tile
  const int tile = blockIdx.x + jt * gridDim.x;
  if (tile >= p.tiles) return;
  for (int x = 0; x < 3; ++x) {
    const int j = U * jt + (SPLIT ? x : 0);
    if ((SPLIT || x == 0) && j >= ring.n) mbar_wait(&ring.empty[j % ring.n], (j / ring.n - 1) & 1);
    copy_tensor(p, tile, x, ring.slot(j) + (SPLIT ? 0 : x * p.nb * kT * p.bw), warp, lane);
    if (SPLIT || x == 2) cp_async_arrive(&ring.full[j % ring.n]);
  }
}

// Classes 1-3, one unit: query frames f0 .. f0 + QF - 1 of the head whose
// columns start at sq, sk, sv (its q, k and v slots); the head's output at
// `out` (frame t at out + t * fs).  Under SPLIT, after the scores the
// thread's last unit of the tile (`last`) releases the q and k slots (uses
// jq, jq + 1), and its first (`first`) waits for v's (jq + 2).
template <int KIND, int V, bool SPLIT>
__device__ __forceinline__ void attend(const float* sq, const float* sk, const float* sv,
                                       const Params& p, int f0, int lane, float* out, long long fs,
                                       const Ring& ring, int jq, bool last, bool first) {
  constexpr int KL = row_lanes(KIND), QL = 32 / KL, KJ = 32 / KL;  // lanes a row, rows, keys a lane
  constexpr int QI = unit_frames(KIND) * KL / 32;  // query frames a lane
  constexpr int DC = 32 / QI, DQ = DC / KL;        // a pass's columns, a lane's share
  constexpr int ROUNDS = KL == 8 ? 3 : 2;          // log2(KL)
  constexpr int SW = V < DQ ? V : DQ;              // a store's floats
  const int bw = p.bw, box = kT * bw;
  const int a = lane / KL, c = lane % KL;

  float s[QI][KJ];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
  // every row and key is computed, T or not: the scores of keys at or past
  // T are masked, rows at or past T never stored
  for (int bx = 0; bx < p.nb; ++bx) {
    const int e1 = min(p.d - bx * p.w, p.w);  // the head's columns in this box
    const float* qb = sq + bx * box;
    const float* kb = sk + bx * box;
#pragma unroll 2
    for (int e = 0; e < e1; e += V) {
      Vec<V> qv[QI];
#pragma unroll
      for (int i = 0; i < QI; ++i) qv[i].load(qb + (f0 + a + QL * i) * bw + e);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        Vec<V> kv;
        kv.load(kb + (c + KL * j) * bw + e);
#pragma unroll
        for (int i = 0; i < QI; ++i)
#pragma unroll
          for (int x = 0; x < V; ++x) s[i][j] = fmaf(qv[i].x[x], kv.x[x], s[i][j]);
      }
    }
  }

  // softmax over the key frames c + KL j, reduced across the row's lanes;
  // scale * log2(e) folded into the exp2's FMA
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      if (c + KL * j >= p.T) s[i][j] = -INFINITY;
      m = fmaxf(m, s[i][j]);
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1 << r));
    const float ms = m * p.scale_log2;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      s[i][j] = exp2_approx(fmaf(s[i][j], p.scale_log2, -ms));
      l += s[i][j];
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) l += __shfl_xor_sync(0xffffffffu, l, 1 << r);
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] *= inv;
  }
  if constexpr (SPLIT) {
    if (last) {
      ring.release(jq);
      ring.release(jq + 1);
    }
    if (first) ring.wait(jq + 2);
  }

  // P V in passes of DC columns through each box; the reduce-scatter (xor
  // 1, 2, 4: round r keeps the half that bit r of c picks) leaves lane c
  // DQ columns at `part`
  int part = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) part += (c >> r & 1) * (DC >> (r + 1));
  for (int bx = 0; bx < p.nb; ++bx) {
    const int e1 = min(p.d - bx * p.w, p.w);
    const float* vb = sv + bx * box;
#pragma unroll 1
    for (int dc0 = 0; dc0 < e1; dc0 += DC) {
      float o[QI][DC];
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int x = 0; x < DC; ++x) o[i][x] = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
#pragma unroll
        for (int m = 0; m < DC / V; ++m) {
          if (dc0 + V * m < e1) {  // a last pass narrower than DC
            Vec<V> vv;
            vv.load(vb + (c + KL * j) * bw + dc0 + V * m);
#pragma unroll
            for (int i = 0; i < QI; ++i)
#pragma unroll
              for (int x = 0; x < V; ++x) o[i][V * m + x] = fmaf(s[i][j], vv.x[x], o[i][V * m + x]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        scatter_round<DC / 2, 0>(o[i], c);
        scatter_round<DC / 4, 1>(o[i], c);
        if constexpr (ROUNDS == 3) scatter_round<DC / 8, 2>(o[i], c);
        const int t = f0 + a + QL * i;
        if (t < p.T) {
          float* dst = out + t * fs + bx * p.w + dc0 + part;
#pragma unroll
          for (int x = 0; x < DQ; x += SW) {
            if (dc0 + part + x < e1) {
              Vec<SW> y;
#pragma unroll
              for (int z = 0; z < SW; ++z) y.x[z] = o[i][x + z];
              y.store(dst + x);
            }
          }
        }
      }
    }
  }
}

// Class 0 (d <= 4), one unit: the lane's (location, head) pair and query
// frame t of its row; scores, softmax and P V in the lane's registers.  DW
// is the head's width (1 to 4: the whole head is one register block, read
// DW floats at a time, or one at a time at DW = 3).
template <int DW>
__device__ __forceinline__ void attend_row(const float* sq, const float* sk, const float* sv,
                                           const Params& p, int t, bool store, float* out,
                                           long long fs) {
  constexpr int V = DW == 3 ? 1 : DW;
  const int bw = p.bw;
  float qv[DW];
#pragma unroll
  for (int x = 0; x < DW; x += V) {
    Vec<V> y;
    y.load(sq + t * bw + x);
#pragma unroll
    for (int z = 0; z < V; ++z) qv[x + z] = y.x[z];
  }
  float s[kT];
  float m = -INFINITY;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < DW; x += V) {
      Vec<V> y;
      y.load(sk + f * bw + x);
#pragma unroll
      for (int z = 0; z < V; ++z) acc = fmaf(qv[x + z], y.x[z], acc);
    }
    s[f] = f < p.T ? acc : -INFINITY;
    m = fmaxf(m, s[f]);
  }
  const float ms = m * p.scale_log2;
  float l = 0.f;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    s[f] = exp2_approx(fmaf(s[f], p.scale_log2, -ms));
    l += s[f];
  }
  const float inv = 1.f / l;
  float o[DW];
#pragma unroll
  for (int x = 0; x < DW; ++x) o[x] = 0.f;
#pragma unroll
  for (int f = 0; f < kT; ++f) {
    const float pf = s[f] * inv;
#pragma unroll
    for (int x = 0; x < DW; x += V) {
      Vec<V> y;
      y.load(sv + f * bw + x);
#pragma unroll
      for (int z = 0; z < V; ++z) o[x + z] = fmaf(pf, y.x[z], o[x + z]);
    }
  }
  if (!store) return;
#pragma unroll
  for (int x = 0; x < DW; x += V) {
    Vec<V> y;
#pragma unroll
    for (int z = 0; z < V; ++z) y.x[z] = o[x + z];
    y.store(out + t * fs + x);
  }
}

// V: the read width of classes 1-4, the head's width (1 to 4) in class 0.
// SPLIT: a slot a tensor (else a slot a tile).  The launch bounds name one
// block an SM: without it ptxas held classes 0 and 3 to 56-96 registers and
// spilled.
template <int KIND, int V, bool STOP, bool SPLIT>
__global__ void __launch_bounds__(32 * ((KIND == 0 ? kMaxRowWarps : kMaxWarps) + 1), 1)
    temporal_any_f32(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int U = SPLIT ? 3 : 1;  // slots a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxSlots;
  // the ring at the first 128-byte boundary past the barriers (TMA's destinations)
  const uint32_t pad = (128u - (smem_u32(smem_raw + kBarBytes) & 127u)) & 127u;
  const int box = kT * p.bw, region = p.nb * box;  // a box's, a tensor's floats
  const Ring ring{full, empty, reinterpret_cast<float*>(smem_raw + kBarBytes + pad),
                  (4 - U) * region, p.slots};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthr = p.nw * 32;  // consumer threads

  if (p.tma && threadIdx.x == 0) {  // the three tensor maps, ahead of the first copies
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  // rows past T are never loaded (every copy writes T rows): zero them once
  // in every box of the ring, so that v's masked keys (probability 0) meet
  // finite rows
  const int zrow = p.bw / 4, zbox = (kT - p.T) * zrow, boxes = p.slots * (4 - U) * p.nb;
  for (int i = threadIdx.x; i < boxes * zbox; i += blockDim.x) {
    const int bx = i / zbox, z = i - bx * zbox;
    reinterpret_cast<float4*>(ring.base + bx * box + p.T * p.bw)[z] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(&full[s], p.tma ? 1 : nthr);
      mbar_init(&empty[s], nthr);
    }
    fence_mbar_init();
  }
  fence_async_smem();  // the zeros before any TMA write
  __syncthreads();

  if (warp == p.nw) {  // the producer warp (TMA only): one thread, nb boxes a tensor
    if (lane != 0) return;
    const uint32_t bytes = (4u - U) * p.nb * p.T * p.bw * 4u;  // a slot's
    const CUtensorMap* maps[3] = {&tq, &tk, &tv};
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
      int b, s0, c0, lv;
      decode(p, tile, b, s0, c0, lv);
      const int col = s0 * p.C + c0;
      for (int x = 0; x < 3; ++x) {
        const int j = U * it + (SPLIT ? x : 0), sl = j % p.slots, n = j / p.slots;
        if (SPLIT || x == 0) {
          if (n > 0) mbar_wait(&empty[sl], (n - 1) & 1);
          mbar_arrive_expect_tx(&full[sl], bytes);
        }
        float* dst = ring.slot(j) + (SPLIT ? 0 : x * region);
        for (int bx = 0; bx < p.nb; ++bx)
          tma_load_3d(dst + bx * box, maps[x], &full[sl], col + bx * p.w, 0, b);
      }
    }
    return;
  }

  // the cp.async loader: slots / U - 1 tiles ahead (under SPLIT the slots a
  // multiple of 3)
  const int ahead = p.slots / U - 1;
  if (!p.tma)
    for (int jt = 0; jt < ahead; ++jt) issue_tile<SPLIT>(p, ring, jt, warp, lane);
  const long long fs = (long long)p.S * p.C;  // a frame's stride in the output
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    if (!p.tma) issue_tile<SPLIT>(p, ring, it + ahead, warp, lane);
    const int jq = U * it;  // q's use (k's and v's the next two under SPLIT)
    ring.wait(jq);
    if (SPLIT) ring.wait(jq + 1);
    int b, s0, c0, lv;
    decode(p, tile, b, s0, c0, lv);
    const float* sq = ring.slot(jq);
    const float* sk = SPLIT ? ring.slot(jq + 1) : sq + region;
    const float* sv = SPLIT ? ring.slot(jq + 2) : sq + 2 * region;
    float* tile_out = p.o + ((long long)b * p.T * p.S + s0) * p.C + c0;
    bool released = false, have_v = false;
    if constexpr (STOP) {  // the copies out alone: the q rows
      for (int r = warp; r < p.T * lv; r += p.nw) {
        const int t = r / lv, l = r - t * lv;
        float* g = tile_out + t * fs + l * p.C;
        for (int e = lane; e < p.cg; e += 32) {
          const int col = l * p.cg + e;
          g[e] = p.nb == 1 ? sq[t * p.bw + col] : sq[(col / p.w) * box + t * p.bw + col % p.w];
        }
      }
    } else if constexpr (KIND == 0) {
      // pairs a unit; the tile's (location, head) pairs, location-major
      const int per = 32 / p.tp, pairs = lv * p.G;
      const int units = (pairs + per - 1) / per;
      const int t = lane % p.tp;
      for (int u = warp; u < units; u += p.nw) {
        const int pair = min(u * per + lane / p.tp, pairs - 1);
        const int l = pair / p.G, h = pair - l * p.G, col = pair * p.d;
        attend_row<V>(sq + col, sk + col, sv + col, p, t, u * per + lane / p.tp < pairs && t < p.T,
                      tile_out + l * p.C + h * p.d, fs);
      }
    } else {
      constexpr int QF = unit_frames(KIND), NZ = kT / QF;  // query slabs a head
      const int units = p.L * p.G * NZ;  // location-major
      // whether the warp has a unit after u: a location before lv, a slab before T
      auto more = [&](int u) {
        for (u += p.nw; u < units && u / (p.G * NZ) < lv; u += p.nw)
          if ((u % NZ) * QF < p.T) return true;
        return false;
      };
      for (int u = warp; u < units; u += p.nw) {
        const int l = u / (p.G * NZ);
        if (l >= lv) break;  // past S, as every later unit
        const int h = (u / NZ) % p.G, f0 = (u % NZ) * QF, col = l * p.cg + h * p.d;
        if (f0 >= p.T) continue;
        const bool last = SPLIT && !more(u);
        attend<KIND, V, SPLIT>(sq + col, sk + col, sv + col, p, f0, lane,
                               tile_out + l * p.C + h * p.d, fs, ring, jq, last, !have_v);
        released |= last;
        have_v = true;
      }
    }
    if (SPLIT) {
      if (!released) {  // this thread's last reads of q and k are done
        ring.release(jq);
        ring.release(jq + 1);
      }
      if (!have_v) ring.wait(jq + 2);
      ring.release(jq + 2);
    } else {
      ring.release(jq);  // this thread's last read of the tile's slot is done
    }
  }
}

// The plan of ops/temporal_attention.any_f32_plan: box geometry, loader,
// width class, warps and slots.  False where no plan fits.
bool plan(Params& p, int sms, int& kind, int& vec, int& smem) {
  if (p.L > 1 && p.B * ((p.S + p.L - 1) / p.L) * p.hgroups < sms) p.L = 1;  // a small batch
  p.cg = p.G * p.d;
  p.sblocks = (p.S + p.L - 1) / p.L;
  p.tiles = p.B * p.sblocks * p.hgroups;
  const int row = p.L * p.cg;
  p.bw = (row + 3) / 4 * 4;
  if ((p.bw / 4) % 2 == 0) p.bw += 4;
  if (p.bw <= kBoxMax) {
    p.nb = 1;
    p.w = p.bw;
  } else {
    p.nb = (row + kBoxMax - 17) / (kBoxMax - 16);
    p.w = ((row + p.nb - 1) / p.nb + 15) / 16 * 16;
    p.bw = p.w + 4;
  }
  p.tma = p.C % 4 == 0 && p.cg % 4 == 0;  // 16-byte frame strides and box starts
  kind = p.d <= 4 ? 0 : p.d <= 32 ? 1 : p.d <= 64 ? 2 : 3;
  vec = p.d % 4 == 0 ? 4 : p.d % 2 == 0 ? 2 : 1;
  p.tp = p.T <= 8 ? 8 : p.T <= 16 ? 16 : 32;
  auto count = [&](int k) {  // a tile's units in class k
    return k == 0 ? (p.L * p.G + 32 / p.tp - 1) / (32 / p.tp)
                  : p.L * p.G * ((p.T + unit_frames(k) - 1) / unit_frames(k));
  };
  int units = count(kind);
  const int tensor = p.nb * kT * p.bw * 4;  // one tensor's rows of a tile, bytes
  const int fixed = kBarBytes + 128;
  p.split = 0;
  if (units >= 8 && fixed + 4 * 3 * tensor <= kSmemMax) {  // one CTA an SM, four tiles
    p.nw = kind == 0 ? std::min(kMaxRowWarps, units) : kMaxWarps, p.slots = 4;
  } else if (2 * (fixed + 2 * 3 * tensor + 1024) <= kSmSmem) {  // two CTAs an SM, two tiles each
    p.nw = std::min(4, units), p.slots = 2;
  } else {  // a slot a tensor
    p.split = 1;
    if (2 * (fixed + 2 * tensor + 1024) <= kSmSmem) {  // two CTAs an SM
      p.nw = std::min(4, units), p.slots = std::min(6, (kSmSmem / 2 - 1024 - fixed) / tensor);
    } else {  // one CTA an SM: class 4, so that a one-head tile feeds eight warps
      if (kind == 3) kind = 4, units = count(4);
      p.nw = std::min(kMaxWarps, units), p.slots = std::min(kMaxSlots, (kSmemMax - fixed) / tensor);
    }
    if (!p.tma) p.slots -= p.slots % 3;  // the cp.async loader copies whole tiles
  }
  smem = fixed + p.slots * (p.split ? tensor : 3 * tensor);
  if (!p.tma && p.nb > 1) return false;
  // split: classes 3 and 4 at 16-byte reads (every width that reaches it), and
  // two slots only for a thread of one unit a tile (its v waits for its own
  // release of q and k)
  return p.split ? kind >= 3 && vec == 4 && p.slots >= (p.tma && units <= p.nw ? 2 : 3)
                 : p.slots >= 1;
}

template <int KIND, int V, bool STOP, bool SPLIT = false>
int launch(const Params& p, int smem, cudaStream_t stream, int sms) {
  auto kern = temporal_any_f32<KIND, V, STOP, SPLIT>;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    configured = true;
  }
  const int threads = 32 * (p.nw + (p.tma ? 1 : 0));
  int per_sm = 1;
  // a runtime call before the maps: it makes the context current (make_map)
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  per_sm = std::max(1, per_sm);
  CUtensorMap maps[3] = {};
  if (p.tma) {
    const float* src[3] = {p.q, p.k, p.v};
    for (int x = 0; x < 3; ++x)
      if (!make_map_rows_f32(&maps[x], src[x], (long long)p.S * p.C, p.T, p.B, p.bw, p.T))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = std::min(p.tiles, per_sm * sms);
  kern<<<grid, threads, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_v(const Params& p, int vec, int smem, cudaStream_t st, int sms) {
  return vec == 4 ? launch<KIND, 4, false>(p, smem, st, sms)
         : vec == 2 ? launch<KIND, 2, false>(p, smem, st, sms)
                    : launch<KIND, 1, false>(p, smem, st, sms);
}

template <bool STOP>
int run(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int C,
        int heads, float scale, int locs, int group, void* stream) {
  if (heads <= 0 || C % heads || T < 1 || T > kT || locs < 1 || group < 1 || heads % group)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.B = B;
  p.T = T;
  p.S = S;
  p.C = C;
  p.d = C / heads;
  p.L = locs;
  p.G = group;
  p.hgroups = heads / group;
  p.scale_log2 = scale * 1.4426950408889634f;
  int kind = 0, vec = 1, smem = 0;
  if (!plan(p, sms, kind, vec, smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (STOP)  // no consumer: one build a ring layout serves
    return p.split ? launch<0, 1, true, true>(p, smem, st, sms)
                   : launch<0, 1, true>(p, smem, st, sms);
  if (p.split)
    return kind == 4 ? launch<4, 4, false, true>(p, smem, st, sms)
                     : launch<3, 4, false, true>(p, smem, st, sms);
  switch (kind) {
    case 0:
      return p.d == 1 ? launch<0, 1, false>(p, smem, st, sms)
             : p.d == 2 ? launch<0, 2, false>(p, smem, st, sms)
             : p.d == 3 ? launch<0, 3, false>(p, smem, st, sms)
                        : launch<0, 4, false>(p, smem, st, sms);
    case 1: return launch_v<1>(p, vec, smem, st, sms);
    case 2: return launch_v<2>(p, vec, smem, st, sms);
    default: return launch_v<3>(p, vec, smem, st, sms);
  }
}

}  // namespace

// q, k, v, o: contiguous (B, T, S, C) fp32, 16-byte aligned, C = heads * d,
// 1 <= T <= 32, d off the instantiated widths.  A tile holds `locs`
// adjacent locations x `group` whole heads (group divides heads):
// ops/temporal_attention.tile_plan at 4-byte elements (where its tiles
// would not cover the SMs, one location a tile).  Returns
// cudaErrorInvalidValue where no plan fits (ops/temporal_attention.
// any_f32_plan's smem is None) or the encoder refuses a tensor map.
extern "C" int vda_temporal_attention_any_f32(const void* q, const void* k, const void* v,
                                              void* o, int B, int T, int S, int C, int heads,
                                              float scale, int locs, int group, void* stream) {
  return run<false>(q, k, v, o, B, T, S, C, heads, scale, locs, group, stream);
}

// The copies alone (the split): the same arguments, out = q.
extern "C" int vda_temporal_attention_any_f32_split(const void* q, const void* k, const void* v,
                                                    void* o, int B, int T, int S, int C, int heads,
                                                    float scale, int locs, int group,
                                                    void* stream) {
  return run<true>(q, k, v, o, B, T, S, C, heads, scale, locs, group, stream);
}
