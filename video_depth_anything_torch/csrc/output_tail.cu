// The fused output tail of the DPT head, for Hopper (sm_90a).
//
// Replaces video_depth_anything_tpu/ops/pallas_output_stack.py:_tail_kernel
// (via fused_output_tail) at every width its gate admits, C in {32, 64,
// 128} (vits' and vitb's heads under ModelConfig(packed_output_stack=False),
// vitl's).  On output_conv1's map x (N, H, W, C) bf16 it
// computes, for each output tile of TH x TW pixels of one frame,
//   bilinear align_corners resize to (out_h, out_w), fp32 arithmetic,
//     rounded to bf16 once after both passes
//   -> conv3x3 C -> 32 (fp32 accumulate, rounded to bf16) + b1 (bf16) -> ReLU
//   -> conv1x1 32 -> 1 (fp32 products of bf16 values, fp32 sum, rounded to
//      bf16) + b2 (bf16) -> ReLU
// and writes only the 1-channel depth: the resized C-channel map never
// touches device memory.  The rounding points are those of _tail_kernel
// and of the plain chain (F.interpolate, then cuDNN's conv with the bias
// added in bf16 after it), as in the PR-2 design this replaces.
//
// Bound on the H100: tensor-core FLOPs.  The conv3x3 costs 2*9*C*32 =
// 73,728 FLOP per output pixel; vitl at 518^2 (32 frames) does 633 GFLOP
// (0.64 ms at 989 TFLOP/s) against ~735 MB of input and output (0.22 ms).
// The PR-2 kernel took 3.28 ms there: its resize prologue 1.68 ms (four
// 16-byte global loads per 8 channels of each of the 10 x 34 resized
// pixels of a 256-pixel tile: 12.3 GB of L1/L2 reads per call), its conv
// 1.45 ms (each of 8 warps streaming all of w1, 73.7 KB, from L1/L2: up to
// 20.8 GB per call), its epilogue 0.09 ms.
//
// Design:
// - Persistent CTAs, one per SM, each walking tiles t = blockIdx.x,
//   t + gridDim.x, ... of TH x TW = 8 x 16 output pixels.  w1 (9 * C * 32
//   bf16, 73.7 KB) is bulk-copied into shared memory once per CTA, on an
//   mbarrier, in the wgmma B layout: K = 9 * C in (dy, dx, c) order,
//   ceil(9 C / 64) tiles of 32 output channels x 64 inputs (18 at C = 128,
//   9 at 64, 5 at 32, whose last tile's upper half is zero), 128-byte
//   swizzled by the host (ops/output_tail.conv_weight_tiles).
// - Warp-specialised: two builder warpgroups make the resized tiles, two
//   consumer warpgroups run the conv, on two tile buffers, so that one
//   tile's resize overlaps the previous tile's conv (the PR-2 kernel ran
//   them one after the other).  Named barriers hand a buffer over: FULL[b]
//   (builders arrive, consumers wait) and EMPTY[b] (the reverse).
// - A builder reads a source patch, not the map: the PATCH_H x PATCH_W
//   source pixels that the tile's taps reach (the wrapper refuses maps
//   whose taps spread wider) are copied into shared memory with cp.async,
//   with the tile's row and column taps (host tables), into one of two
//   buffers while the other's tile is built.  The resized tile plus its 1-pixel conv
//   halo ((TH+2) x (TW+2) x C bf16) is computed from there with the PR-2
//   fp32 arithmetic, zero outside the map.
// - The conv3x3 is an implicit GEMM on wgmma m64n32k16: each consumer
//   warpgroup takes 64 output pixels (four rows of 16, one per warp), N =
//   32, K = 9 * C.  A comes from registers, as ldmatrix fragments of the
//   tile at each tap's (dy, dx) offset: a one-pixel shift moves a
//   fragment's rows, which a shared-memory descriptor cannot express
//   without a copy per tap.  Two fragment sets alternate, so one tap's
//   loads overlap the previous tap's products.  B comes from w1 in shared
//   memory.  The tile's pixels are rows of 2 C bytes whose 16-byte chunks
//   are XOR-swizzled so that ldmatrix's eight rows of a matrix (eight
//   consecutive pixels, one chunk) fall in eight different bank groups: by
//   pixel % 8 within each 128-byte half at C = 128 and 64; at C = 32 (64-byte
//   rows, two pixels a 128-byte line) by (pixel / 2) % 4, pixel parity
//   choosing the line's half.
// - Bias, ReLU, the 1x1, its bias and ReLU run in the epilogue on the
//   accumulators: the 4 lanes that share a pixel hold its 32 channels and
//   reduce them with two shuffles.
// The TPU's frame packing into lanes, hi/lo bf16 split of the fp32 weights
// (an MXU workaround), banded horizontal GEMM chunks and row-block DMA
// spans are not carried over.
//
// STOP < 2 (the split): the consumers skip the conv (0: each writes one
// resized value per output pixel) or the epilogue's arithmetic (1).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MID = 32;     // output_conv2's hidden width
constexpr int TH = 8;       // output rows per tile, four per consumer warpgroup
constexpr int TW = 16;      // output columns per tile
constexpr int HH = TH + 2;  // resized tile rows with the conv halo
constexpr int HW = TW + 2;  // resized tile columns with the conv halo
constexpr int NTHREADS = 512;  // consumer warpgroups 0-1, builder warpgroups 2-3
constexpr int NB = 256;        // builder threads
constexpr int PATCH_H = 8, PATCH_W = 12;  // source pixels a tile's taps may reach
constexpr int W1_TILE = MID * 64;         // bf16 per B tile
// 16-byte chunks per pixel, and the B tiles of 32 x 64 of K = 9 C
template <int C>
__host__ __device__ constexpr int chunks() { return C / 8; }
template <int C>
__host__ __device__ constexpr int w1_tiles() { return (9 * C + 63) / 64; }
// named barriers (0 is __syncthreads)
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_BUILD = 5;

// One output row's or column's taps, relative to the tile's patch origin
// (lo < 0: outside the map, a zero row or column of the halo).  The host
// builds, per tile row and per tile column, the origin (entry 0, in lo)
// and the TH + 2 or TW + 2 halo taps (ops/output_tail._tile_taps).
struct __align__(16) Tap {
  int lo, hi;
  float w_lo, w_hi;
};

template <int C>
struct Smem {
  bf16 w1[w1_tiles<C>() * W1_TILE];      // C = 128: 73,728 B, 1024-aligned tiles
  bf16 tile[2][HH * HW * C];             // 2 x 46,080 B
  bf16 patch[2][PATCH_H * PATCH_W * C];  // 2 x 24,576 B
  Tap rows[2][HH], cols[2][HW];
  uint64_t w1_full;
};
template <int C>
constexpr int smem_bytes() { return sizeof(Smem<C>) + 1024; }

// element offset of chunk j (8 channels) of resized pixel p in a tile
template <int C>
__device__ __forceinline__ int tile_at(int p, int j) {
  if constexpr (C == 32) return p * C + ((j ^ ((p >> 1) & 3)) << 3);
  return p * C + (((j & 8) | ((j & 7) ^ (p & 7))) << 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

struct Geometry {
  int N, H, W, out_h, out_w, tiles_x, tiles_y;
};

// Tile t's frame, tile row and tile column, and its source patch origin
// (entry 0 of its row's and column's tap tables).
struct TileAt {
  int n, ty, tx, py0, px0;
  __device__ TileAt(int t, const Geometry& g) {
    n = t / (g.tiles_y * g.tiles_x);
    ty = t / g.tiles_x % g.tiles_y;
    tx = t % g.tiles_x;
  }
  __device__ void origin(const Tap* ytab, const Tap* xtab) {
    py0 = ytab[ty * (HH + 1)].lo;
    px0 = xtab[tx * (HW + 1)].lo;
  }
  // the tile's taps and source patch by builder thread bt, committed as
  // one cp.async group
  template <int C>
  __device__ void copy(Tap* rows, Tap* cols, bf16* patch, const Tap* ytab, const Tap* xtab,
                       const bf16* x, const Geometry& g, int bt) const {
    if (bt < HH) cp_async16(rows + bt, ytab + ty * (HH + 1) + 1 + bt);
    else if (bt < HH + HW) cp_async16(cols + bt - HH, xtab + tx * (HW + 1) + 1 + bt - HH);
    constexpr int CH = chunks<C>();
    const bf16* xn = x + (long long)n * g.H * g.W * C;
    for (int i = bt; i < PATCH_H * PATCH_W * CH; i += NB) {
      const int pr = i / (PATCH_W * CH), pc = (i / CH) % PATCH_W, j = i % CH;
      const int sy = min(py0 + pr, g.H - 1), sx = min(px0 + pc, g.W - 1);
      cp_async16(patch + (pr * PATCH_W + pc) * C + j * 8,
                 xn + ((long long)sy * g.W + sx) * C + j * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

template <int C, int STOP>
__global__ void __launch_bounds__(NTHREADS, 1) output_tail_hopper(
    const bf16* __restrict__ x, const Tap* __restrict__ ytab, const Tap* __restrict__ xtab,
    const bf16* __restrict__ w1, const float* __restrict__ epi, bf16* __restrict__ out,
    const Geometry g) {
  constexpr int CH = chunks<C>(), W1_TILES = w1_tiles<C>();
  extern __shared__ unsigned char smem_raw[];
  Smem<C>& sm = aligned_smem<Smem<C>>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = g.N * g.tiles_y * g.tiles_x;
  if (tid == 0) {
    mbar_init(&sm.w1_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= NTHREADS - NB) {  // builders
    const int bt = tid - (NTHREADS - NB);
    const int stride = gridDim.x;
    // tile k + 1's origin is read a tile ahead of its copy, and tile k +
    // 1's taps and patch are copied while tile k is built: no global
    // load waits on the build's path
    TileAt next(blockIdx.x, g);
    if (static_cast<int>(blockIdx.x) < n_tiles) {
      next.origin(ytab, xtab);
      next.copy<C>(sm.rows[0], sm.cols[0], sm.patch[0], ytab, xtab, x, g, bt);
    }
    if (static_cast<int>(blockIdx.x) + stride < n_tiles) {
      next = TileAt(blockIdx.x + stride, g);
      next.origin(ytab, xtab);
    }
    int k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += stride, ++k) {
      const int b = k & 1;
      const bool more = tile + stride < n_tiles;
      if (more) {
        next.copy<C>(sm.rows[b ^ 1], sm.cols[b ^ 1], sm.patch[b ^ 1], ytab, xtab, x, g, bt);
        if (tile + 2 * stride < n_tiles) {
          next = TileAt(tile + 2 * stride, g);
          next.origin(ytab, xtab);
        }
      }
      if (k >= 2) bar_sync(BAR_EMPTY + b, NTHREADS);  // the consumers are done with buffer b
      if (more)  // this tile's copy is the older of the two groups in flight
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      bar_sync(BAR_BUILD, NB);  // the patch and the taps are in
      bf16* tb = sm.tile[b];
      // thread bt: chunk j = bt % CH of pixels bt / CH + (NB / CH) m, in
      // batches of four whose shared-memory loads all issue before any
      // store (a store could alias the loads, so the compiler would not
      // hoist them itself)
      const int j = bt % CH;
      const bf16* src = sm.patch[b] + j * 8;
#pragma unroll 1
      for (int p0 = bt / CH; p0 < HH * HW; p0 += 4 * (NB / CH)) {
        uint4 v[4][4];
        Tap ty[4], tx[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = min(p0 + m * (NB / CH), HH * HW - 1);
          ty[m] = sm.rows[b][p / HW];
          tx[m] = sm.cols[b][p % HW];
          const int y0 = max(ty[m].lo, 0), y1 = max(ty[m].hi, 0);
          const int x0 = max(tx[m].lo, 0), x1 = max(tx[m].hi, 0);
          v[m][0] = *reinterpret_cast<const uint4*>(src + (y0 * PATCH_W + x0) * C);
          v[m][1] = *reinterpret_cast<const uint4*>(src + (y0 * PATCH_W + x1) * C);
          v[m][2] = *reinterpret_cast<const uint4*>(src + (y1 * PATCH_W + x0) * C);
          v[m][3] = *reinterpret_cast<const uint4*>(src + (y1 * PATCH_W + x1) * C);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = p0 + m * (NB / CH);
          if (p >= HH * HW) break;
          uint4 r = make_uint4(0u, 0u, 0u, 0u);
          if (ty[m].lo >= 0 && tx[m].lo >= 0) {
            const bf162* a2 = reinterpret_cast<const bf162*>(&v[m][0]);
            const bf162* b2 = reinterpret_cast<const bf162*>(&v[m][1]);
            const bf162* d2 = reinterpret_cast<const bf162*>(&v[m][2]);
            const bf162* e2 = reinterpret_cast<const bf162*>(&v[m][3]);
            uint32_t* r2 = reinterpret_cast<uint32_t*>(&r);
            const float wy0 = ty[m].w_lo, wy1 = ty[m].w_hi, wx0 = tx[m].w_lo, wx1 = tx[m].w_hi;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 fa = __bfloat1622float2(a2[q]), fb = __bfloat1622float2(b2[q]);
              const float2 fd = __bfloat1622float2(d2[q]), fe = __bfloat1622float2(e2[q]);
              const float lo = wy0 * (wx0 * fa.x + wx1 * fb.x) + wy1 * (wx0 * fd.x + wx1 * fe.x);
              const float hi = wy0 * (wx0 * fa.y + wx1 * fb.y) + wy1 * (wx0 * fd.y + wx1 * fe.y);
              r2[q] = pack_bf16x2(lo, hi);
            }
          }
          *reinterpret_cast<uint4*>(tb + tile_at<C>(p, j)) = r;
        }
      }
      bar_sync(BAR_BUILD, NB);  // the patch buffer and the taps are free
      bar_arrive(BAR_FULL + b, NTHREADS);
    }
    // match the consumers' last arrivals on EMPTY
    for (int last = max(k - 2, 0); last < k; ++last) bar_sync(BAR_EMPTY + (last & 1), NTHREADS);
    return;
  }

  // consumers: warpgroup cw takes output rows 4cw .. 4cw + 3 of a tile, warp
  // wq of it row 4cw + wq, columns 0 .. 15
  const int orow = warp;  // = 4 * cw + wq
  if (STOP > 0 && tid == 0) {
    mbar_arrive_expect_tx(&sm.w1_full, W1_TILES * W1_TILE * 2);
    for (int t = 0; t < W1_TILES; ++t)
      bulk_load(sm.w1 + t * W1_TILE, w1 + t * W1_TILE, W1_TILE * 2, &sm.w1_full);
  }
  if (STOP > 0) mbar_wait(&sm.w1_full, 0);
  const uint64_t dw = desc_sw128(sm.w1);
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int b = k & 1;
    const int t_ox0 = (tile % g.tiles_x) * TW, t_oy0 = (tile / g.tiles_x % g.tiles_y) * TH;
    const int t_n = tile / (g.tiles_y * g.tiles_x);
    const int oy = t_oy0 + orow;
    bar_sync(BAR_FULL + b, NTHREADS);
    const bf16* tb = sm.tile[b];
    if (STOP == 0) {
      const int ox = t_ox0 + (lane & 15);
      if (lane < 16 && oy < g.out_h && ox < g.out_w)
        out[((long long)t_n * g.out_h + oy) * g.out_w + ox] =
            tb[tile_at<C>((orow + 1) * HW + (lane & 15) + 1, 0)];
      bar_arrive(BAR_EMPTY + b, NTHREADS);
      continue;
    }

    // conv3x3 as an implicit GEMM, tap by tap, two fragment sets in turn
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    uint32_t af[2][C / 16][4];
    auto load_tap = [&](uint32_t (&a)[C / 16][4], int tap) {
      const int p = (orow + tap / 3) * HW + tap % 3 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        ldmatrix_x4(a[kk][0], a[kk][1], a[kk][2], a[kk][3],
                    tb + tile_at<C>(p, 2 * kk + (lane >> 4)));
    };
    load_tap(af[0], 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const int q = tap * (C / 16) + kk;  // k16 step; four per 64-wide B tile
        wgmma_rs_n32(acc, af[tap & 1][kk], dw + (q >> 2) * (W1_TILE * 2 / 16) + 2 * (q & 3), q > 0);
      }
      wgmma_commit();
      if (tap < 8) {
        wgmma_wait<1>();  // the previous tap's products are done with their fragments
        load_tap(af[(tap + 1) & 1], tap + 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_arrive(BAR_EMPTY + b, NTHREADS);  // the tile is read

    // epilogue: + b1, ReLU, 1x1 (reduced over the 4 lanes of a pixel), + b2,
    // ReLU; epi = [b1 (32), w2 (32), b2], bf16 values in fp32
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = t * 8 + (lane & 3) * 2 + e;
          const float v = acc[4 * t + 2 * hf + e];
          if (STOP == 1) {
            s += v;
          } else {
            const float z = fmaxf(bf16_round(bf16_round(v) + epi[ch]), 0.f);
            s = fmaf(z, epi[MID + ch], s);
          }
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int ox = t_ox0 + (lane >> 2) + hf * 8;
      if ((lane & 3) == 0 && oy < g.out_h && ox < g.out_w)
        out[((long long)t_n * g.out_h + oy) * g.out_w + ox] = __float2bfloat16_rn(
            STOP == 1 ? s : fmaxf(bf16_round(bf16_round(s) + epi[2 * MID]), 0.f));
    }
  }
}

template <int C, int STOP>
int launch(const bf16* x, const Tap* ytab, const Tap* xtab, const bf16* w1, const float* epi,
           bf16* out, int N, int H, int W, int out_h, int out_w, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<C>();
  cudaError_t e = cudaFuncSetAttribute(output_tail_hopper<C, STOP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Geometry g{N, H, W, out_h, out_w, (out_w + TW - 1) / TW, (out_h + TH - 1) / TH};
  const int n_tiles = N * g.tiles_x * g.tiles_y;
  output_tail_hopper<C, STOP><<<min(n_tiles, sms), NTHREADS, SMEM, stream>>>(x, ytab, xtab, w1,
                                                                             epi, out, g);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*LaunchFn)(const bf16*, const Tap*, const Tap*, const bf16*, const float*, bf16*,
                        int, int, int, int, int, cudaStream_t);

int run(LaunchFn fn, const void* x, const void* ytab, const void* xtab, const void* w1,
        const void* epi, void* out, int N, int H, int W, int out_h, int out_w, cudaStream_t st) {
  return fn(static_cast<const bf16*>(x), static_cast<const Tap*>(ytab),
            static_cast<const Tap*>(xtab), static_cast<const bf16*>(w1),
            static_cast<const float*>(epi), static_cast<bf16*>(out), N, H, W, out_h, out_w, st);
}

// the instantiation of width c, stage STOP; nullptr for a width without one
template <int STOP>
LaunchFn launcher(int c) {
  switch (c) {
    case 32: return launch<32, STOP>;
    case 64: return launch<64, STOP>;
    case 128: return launch<128, STOP>;
    default: return nullptr;
  }
}

}  // namespace

// x: contiguous (N, H, W, C) bf16, C in {32, 64, 128}; ytab / xtab: per
// tile row / column, the patch origin and the TH + 2 / TW + 2 halo taps
// (Tap, 16 bytes each), every tap within a PATCH_H x PATCH_W source patch
// (the wrapper checks); w1 as ceil(9 C / 64) swizzled tiles of 32 x 64 (K
// = 9 * C in (dy, dx, c) order, zero past it); epi: fp32 [b1 (32), w2
// (32), b2]; out: contiguous (N, out_h, out_w) bf16.
extern "C" int vda_output_tail(const void* x, const void* ytab, const void* xtab, const void* w1,
                               const void* epi, void* out, int N, int H, int W, int c, int out_h,
                               int out_w, void* stream) {
  const LaunchFn fn = launcher<2>(c);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(fn, x, ytab, xtab, w1, epi, out, N, H, W, out_h, out_w,
             static_cast<cudaStream_t>(stream));
}

// The split: ms[k] = mean ms of `iters` launches of the kernel stopped after
// the resize (0), the conv (1), and whole (2); CUDA events, synchronises
// the stream.
extern "C" int vda_output_tail_split(const void* x, const void* ytab, const void* xtab,
                                     const void* w1, const void* epi, void* out, int N, int H,
                                     int W, int c, int out_h, int out_w, void* stream, int iters,
                                     float* ms) {
  const LaunchFn fns[3] = {launcher<0>(c), launcher<1>(c), launcher<2>(c)};
  if (fns[0] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int err = 0;
  for (int k = 0; k < 3 && err == 0; ++k) {
    err = run(fns[k], x, ytab, xtab, w1, epi, out, N, H, W, out_h, out_w, st);
    cudaEventRecord(e0, st);
    for (int i = 0; i < iters && err == 0; ++i)
      err = run(fns[k], x, ytab, xtab, w1, epi, out, N, H, W, out_h, out_w, st);
    cudaEventRecord(e1, st);
    if (err == 0) err = static_cast<int>(cudaEventSynchronize(e1));
    if (err == 0) err = static_cast<int>(cudaEventElapsedTime(&ms[k], e0, e1));
    ms[k] /= iters;
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return err;
}
