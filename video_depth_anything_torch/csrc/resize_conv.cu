// Fused bilinear resize -> conv3x3 + bias, for Hopper (sm_90a).
//
// Replaces video_depth_anything_tpu/ops/pallas_resize_conv.py:
// _resize_conv_kernel (via fused_resize_conv / try_fused_resize_conv).  On
// x (N, H, W, C) bf16, C a multiple of 128, it computes for each output
// tile of TH x TW pixels of one frame
//   bilinear align_corners resize to (out_h, out_w), fp32 arithmetic,
//     rounded to bf16 once after both passes
//   -> conv3x3 C -> 128 (padding 1; fp32 accumulate, rounded to bf16)
//   -> + b (bf16), rounded to bf16
// and writes the (N, out_h, out_w, 128) bf16 result: the resized C-channel
// map never touches device memory.  The rounding points are those of the
// TPU kernel and of the plain chain (F.interpolate, then a conv summed in
// fp32 and rounded once, then the bias added in bf16).  Like the TPU
// kernel, no model path calls it: it is a standalone differentiable op
// (ResizeConvFn).
//
// Bound on the H100: tensor-core FLOPs.  The conv costs 2*9*C*128 FLOP per
// output pixel: at the vitl junction (32, 148, 148, 256) -> 296^2 that is
// 1.654 TFLOP (1.67 ms at 989 TFLOP/s) against 359 MB in and 718 MB out
// (0.32 ms at 3.35 TB/s).  The mma.sync design this replaces took 5.9 ms:
// its resize (1.36 ms alone) and its GEMM (4.10 ms alone, each warp
// streaming its half of the 590 KB of weights from L1/L2: 7 GB a call)
// ran one after the other.
//
// Design: the output tail's (csrc/output_tail.cu), adapted to a 128-wide
// output whose weights (9 * C * 128 bf16, 590 KB at C = 256) do not fit in
// shared memory.
// - Persistent CTAs, one per SM, each walking tiles t = blockIdx.x,
//   t + gridDim.x, ... of TH x TW = 16 x 16 output pixels; K = 9 * C is
//   walked in 64-channel chunks, each chunk tap by tap.
// - Warp-specialised, 640 threads: four consumer warpgroups run the conv
//   as an implicit GEMM, one builder warpgroup makes the resized tile plus
//   its one-pixel halo, 18 x 18 pixels of one 64-channel chunk, into one
//   of two buffers while the consumers read the other.  Named barriers
//   hand a buffer over: FULL[b] (builders arrive, consumers wait) and
//   EMPTY[b] (the reverse).
// - The weights stream through a ring of STAGES shared-memory stages on
//   mbarriers, one (chunk, tap) B tile of 128 output channels x 64 inputs
//   (16 KB, 128-byte swizzled by the host: ops/resize_conv.weight_tiles)
//   a stage, bulk-copied; every tile in shared memory serves all 256
//   pixels of the CTA.  There is no producer warp: the last of the four
//   consumer warpgroups to release a stage refills it.
// - The conv: each consumer warpgroup owns 64 output pixels, an 8 x 8
//   block, in one wgmma m64n128k16 accumulator (64 fp32 a thread), A and B
//   from shared memory.  The resized tile is laid out with no swizzle in
//   16-byte core-matrix rows, channel-octet major: pixel p (halo row-major,
//   HW = 18 a row), octet o at (o * NP + p) * 16 bytes, NP = 325 (odd, so
//   the builders' eight octets of a pixel go to eight bank groups).  An
//   8 x 8 block is then a wgmma A operand as it stands: a core matrix is
//   eight pixels of one row (16 B apart), the next core matrix along M the
//   next row (SBO = HW * 16 B), along K the next octet (LBO = NP * 16 B),
//   and a tap's (dy, dx) shift moves the descriptor's start by
//   (dy * HW + dx) * 16 B: no copy and no ldmatrix per tap.
// - A builder reads a source patch, not the map: the PATCH_H x PATCH_W
//   source pixels of the chunk that the tile's taps reach, copied into
//   shared memory with cp.async (with the tile's tap tables, host-built)
//   while the previous chunk is built.  Where the taps of a tile spread
//   wider (downsampling, or near-identity sizes), the launch takes the
//   template without the patch, whose builders read the four taps from
//   global memory, as the mma.sync kernel did.  Zero outside the map.
// - The epilogue rounds each accumulator to bf16, adds the bias (bf16
//   values) and rounds again, while the builders make the next tile.
// The TPU kernel's hi/lo bf16 split of the interpolation weights (an MXU
// workaround), its banded horizontal GEMM chunks and its row-block DMA
// spans are not carried over.
//
// RC_STOP (bench_resize_conv's builds; 0 as shipped): 1 skips the conv's
// products (the epilogue stores the bias), 2 skips the resize (no patch is
// copied and the tile is never built), 3 skips both: the weight ring, the
// hand-overs and the stores.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

#ifndef RC_STOP
#define RC_STOP 0
#endif

namespace {

constexpr int COUT = 128;
constexpr int CK = 64;           // channels a chunk: one B tile's K
constexpr int TH = 16, TW = 16;  // output pixels a tile
constexpr int HH = TH + 2, HW = TW + 2;  // the resized tile with its conv halo
constexpr int HP = HH * HW;      // 324 halo pixels
constexpr int NP = HP + 1;       // pixels an octet plane (odd)
constexpr int OCT = CK / 8;      // 16-byte octets a pixel of a chunk
constexpr int PATCH_H = 12, PATCH_W = 12;  // source pixels a tile's taps may reach
constexpr int STAGES = 4;        // the weight ring
constexpr int W_TILE = COUT * CK;  // bf16 a B tile
constexpr int NCONS = 4;         // consumer warpgroups
constexpr int NB = 128;          // builder threads: one warpgroup
constexpr int NTHREADS = NCONS * 128 + NB;
// named barriers (0 is __syncthreads)
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_BUILD = 5;

// One output row's or column's taps, relative to the tile's patch origin
// (lo < 0: outside the map, a zero row or column of the halo); entry 0 of
// a tile's table holds the origin in lo (ops/output_tail._tile_taps).
struct __align__(16) Tap {
  int lo, hi;
  float w_lo, w_hi;
};

struct Smem {
  bf16 w[STAGES][W_TILE];           // 16 KB each, 1024-aligned B tiles
  bf16 tile[2][OCT * NP * 8];       // 2 x 41,600 B
  bf16 patch[2][PATCH_H * PATCH_W * CK];  // 2 x 18,432 B
  Tap rows[2][HH + 1], cols[2][HW + 1];
  uint64_t full[STAGES];
  int released[STAGES];
};
constexpr int SMEM = sizeof(Smem) + 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

struct Geometry {
  int N, H, W, C, out_h, out_w, tiles_x, tiles_y;
};

// The bilinear value of 8 channels from four 16-byte taps, fp32 lerps
// (the row's two columns, then the rows), rounded to bf16 once.
__device__ __forceinline__ uint4 lerp8(const uint4& a, const uint4& b, const uint4& d,
                                       const uint4& e, const Tap& ty, const Tap& tx) {
  uint4 r;
  const bf162* a2 = reinterpret_cast<const bf162*>(&a);
  const bf162* b2 = reinterpret_cast<const bf162*>(&b);
  const bf162* d2 = reinterpret_cast<const bf162*>(&d);
  const bf162* e2 = reinterpret_cast<const bf162*>(&e);
  uint32_t* r2 = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 fa = __bfloat1622float2(a2[q]), fb = __bfloat1622float2(b2[q]);
    const float2 fd = __bfloat1622float2(d2[q]), fe = __bfloat1622float2(e2[q]);
    const float lo = ty.w_lo * (tx.w_lo * fa.x + tx.w_hi * fb.x) +
                     ty.w_hi * (tx.w_lo * fd.x + tx.w_hi * fe.x);
    const float hi = ty.w_lo * (tx.w_lo * fa.y + tx.w_hi * fb.y) +
                     ty.w_hi * (tx.w_lo * fd.y + tx.w_hi * fe.y);
    r2[q] = pack_bf16x2(lo, hi);
  }
  return r;
}

template <bool PATCH>
__global__ void __launch_bounds__(NTHREADS, 1) resize_conv_hopper(
    const bf16* __restrict__ x, const Tap* __restrict__ ytab, const Tap* __restrict__ xtab,
    const bf16* __restrict__ w, const float* __restrict__ bias, bf16* __restrict__ out,
    const Geometry g) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tid = threadIdx.x;
  const int n_tiles = g.N * g.tiles_y * g.tiles_x;
  const int nch = g.C / CK;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int items = my_tiles * nch;           // (tile, chunk) steps of this CTA
  const int wsteps = 9 * nch;                 // B tiles a pass over K
  const int total = my_tiles * wsteps;        // the weight ring's loads
  auto load_w = [&](int gw) {  // B tile of weight step gw into its stage
    const int s = gw % STAGES;
    mbar_arrive_expect_tx(&sm.full[s], W_TILE * 2);
    bulk_load(sm.w[s], w + (long long)(gw % wsteps) * W_TILE, W_TILE * 2, &sm.full[s]);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.released[s] = 0;
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= NCONS * 128) {  // the builders
    const int bt = tid - NCONS * 128;
    // the patch origin of this CTA's tile tk (entry 0 of its tables), read
    // from global memory a tile before it is needed
    int org[2][2] = {{0, 0}, {0, 0}};  // the current tile's (y, x), the next one's
    auto origin = [&](int tk, int (&o)[2]) {
      const int t = blockIdx.x + tk * gridDim.x;
      if (PATCH && t < n_tiles) {
        o[0] = ytab[(t / g.tiles_x % g.tiles_y) * (HH + 1)].lo;
        o[1] = xtab[(t % g.tiles_x) * (HW + 1)].lo;
      }
    };
    origin(0, org[0]);
    origin(1, org[1]);
    // item k's tile and chunk; its tap tables and (PATCH) source patch
    // into buffer k & 1, committed as one cp.async group
    auto copy = [&](int k) {
      const int b = k & 1, t = blockIdx.x + (k / nch) * gridDim.x, cc = k % nch;
      const int n = t / (g.tiles_y * g.tiles_x), ty = t / g.tiles_x % g.tiles_y,
                tx = t % g.tiles_x;
      if (k > 0 && cc == 0) {  // a new tile
        org[0][0] = org[1][0];
        org[0][1] = org[1][1];
        origin(k / nch + 1, org[1]);
      }
      if (bt <= HH) cp_async16(&sm.rows[b][bt], ytab + ty * (HH + 1) + bt);
      else if (bt <= HH + HW + 1) cp_async16(&sm.cols[b][bt - HH - 1], xtab + tx * (HW + 1) + bt - HH - 1);
      if constexpr (PATCH && RC_STOP < 2) {
        const int py0 = org[0][0], px0 = org[0][1];
        const bf16* xn = x + (long long)n * g.H * g.W * g.C + cc * CK;
        for (int i = bt; i < PATCH_H * PATCH_W * OCT; i += NB) {
          const int pr = i / (PATCH_W * OCT), pc = i / OCT % PATCH_W, j = i % OCT;
          const int sy = min(py0 + pr, g.H - 1), sx = min(px0 + pc, g.W - 1);
          cp_async16(sm.patch[b] + (pr * PATCH_W + pc) * CK + j * 8,
                     xn + ((long long)sy * g.W + sx) * g.C + j * 8);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (items > 0) copy(0);
    for (int k = 0; k < items; ++k) {
      const int b = k & 1;
      if (k + 1 < items) copy(k + 1);
      if (k >= 2) bar_sync(BAR_EMPTY + b, NTHREADS);  // the consumers are done with buffer b
      if (k + 1 < items)  // item k's copy is the older of the two groups in flight
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      bar_sync(BAR_BUILD, NB);  // the tables and the patch are in
      if constexpr (RC_STOP < 2) {
        const int t = blockIdx.x + (k / nch) * gridDim.x, cc = k % nch;
        const int n = t / (g.tiles_y * g.tiles_x);
        const Tap* rows = sm.rows[b];
        const Tap* cols = sm.cols[b];
        const int oy0 = rows[0].lo, ox0 = cols[0].lo;  // the patch origin
        const bf16* xn = x + (long long)n * g.H * g.W * g.C + cc * CK;
        bf16* tb = sm.tile[b];
        // thread bt: octet o = bt % 8 of pixels bt / 8 + 16 m, two at a
        // time, both pixels' loads issued before either store
#pragma unroll 1
        for (int i0 = bt; i0 < HP * OCT; i0 += 2 * NB) {
          uint4 v[2][4];
          Tap ty[2], tx[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = min(i0 + u * NB, HP * OCT - 1), p = i / OCT, o = i % OCT;
            ty[u] = rows[1 + p / HW];
            tx[u] = cols[1 + p % HW];
            const int y0 = max(ty[u].lo, 0), y1 = max(ty[u].hi, 0);
            const int x0 = max(tx[u].lo, 0), x1 = max(tx[u].hi, 0);
            if constexpr (PATCH) {
              const bf16* src = sm.patch[b] + o * 8;
              v[u][0] = *reinterpret_cast<const uint4*>(src + (y0 * PATCH_W + x0) * CK);
              v[u][1] = *reinterpret_cast<const uint4*>(src + (y0 * PATCH_W + x1) * CK);
              v[u][2] = *reinterpret_cast<const uint4*>(src + (y1 * PATCH_W + x0) * CK);
              v[u][3] = *reinterpret_cast<const uint4*>(src + (y1 * PATCH_W + x1) * CK);
            } else {
              const bf16* src = xn + o * 8;
              const long long r0 = (long long)(oy0 + y0) * g.W, r1 = (long long)(oy0 + y1) * g.W;
              v[u][0] = __ldg(reinterpret_cast<const uint4*>(src + (r0 + ox0 + x0) * g.C));
              v[u][1] = __ldg(reinterpret_cast<const uint4*>(src + (r0 + ox0 + x1) * g.C));
              v[u][2] = __ldg(reinterpret_cast<const uint4*>(src + (r1 + ox0 + x0) * g.C));
              v[u][3] = __ldg(reinterpret_cast<const uint4*>(src + (r1 + ox0 + x1) * g.C));
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = i0 + u * NB;
            if (i >= HP * OCT) break;
            uint4 r = make_uint4(0u, 0u, 0u, 0u);
            if (ty[u].lo >= 0 && tx[u].lo >= 0)
              r = lerp8(v[u][0], v[u][1], v[u][2], v[u][3], ty[u], tx[u]);
            *reinterpret_cast<uint4*>(tb + ((i % OCT) * NP + i / OCT) * 8) = r;
          }
        }
        fence_async_smem();  // the tile is read by wgmma (the async proxy)
      }
      bar_sync(BAR_BUILD, NB);  // the patch buffer and the tables are free
      bar_arrive(BAR_FULL + b, NTHREADS);
    }
    // match the consumers' last arrivals on EMPTY
    for (int last = max(items - 2, 0); last < items; ++last)
      bar_sync(BAR_EMPTY + (last & 1), NTHREADS);
    return;
  }

  // consumers: warpgroup cw owns the 8 x 8 block at tile rows 8 (cw / 2)..,
  // columns 8 (cw % 2)..
  const int cw = tid / 128, ctid = tid % 128, warp = ctid >> 5, lane = ctid & 31;
  const int r0 = 8 * (cw >> 1), c0 = 8 * (cw & 1);
  if (tid == 0)
    for (int gw = 0; gw < min(STAGES, total); ++gw) load_w(gw);
  // the stage of weight step gw is read: the last warpgroup to say so refills it
  auto release = [&](int gw) {
    if (ctid == 0 && atomicAdd(&sm.released[gw % STAGES], 1) % NCONS == NCONS - 1 &&
        gw + STAGES < total)
      load_w(gw + STAGES);
  };
  float acc[64];
  int gw = 0, k = 0;  // weight step, item
  // one chunk: the nine taps' products on tile buffer k & 1; FIRST: the
  // tile's first chunk, whose first product overwrites acc
  auto chunk = [&](auto first_c) {
    constexpr bool FIRST = decltype(first_c)::value;
    const int b = k & 1;
    bar_sync(BAR_FULL + b, NTHREADS);
    const uint64_t da = desc_noswizzle(sm.tile[b] + (r0 * HW + c0) * 8, NP * 16, HW * 16);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int s = gw % STAGES;
      mbar_wait(&sm.full[s], (gw / STAGES) & 1);
      const uint64_t db = desc_sw128(sm.w[s]);
      const uint64_t dt = da + (tap / 3) * HW + tap % 3;  // the tap's shift, in 16 B
      wgmma_fence();
      if constexpr (RC_STOP != 1 && RC_STOP != 3) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n128(acc, dt + 2 * ks * NP, db + 2 * ks, FIRST && tap == 0 && ks == 0 ? 0 : 1);
      }
      wgmma_commit();
      if (!(FIRST && tap == 0)) {  // folded: tap is unrolled
        wgmma_wait<1>();  // the previous step's products are done
        release(gw - 1);
        if (tap == 0) bar_arrive(BAR_EMPTY + (b ^ 1), NTHREADS);  // the previous chunk's tile
      }
      ++gw;
    }
    ++k;
  };
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    if constexpr (RC_STOP == 1 || RC_STOP == 3) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    chunk(std::true_type());
    for (int cc = 1; cc < nch; ++cc) chunk(std::false_type());
    wgmma_wait<0>();
    fence_regs(acc);
    release(gw - 1);
    bar_arrive(BAR_EMPTY + ((k - 1) & 1), NTHREADS);
    // epilogue: round, + bias (bf16 values in fp32), round, store; thread
    // (warp, lane) holds pixels (2 warp + h, lane / 4) of the block
    const int n = t / (g.tiles_y * g.tiles_x);
    const int oy0 = (t / g.tiles_x % g.tiles_y) * TH + r0 + 2 * warp;
    const int ox = (t % g.tiles_x) * TW + c0 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oy = oy0 + h;
      if (oy >= g.out_h || ox >= g.out_w) continue;
      bf16* dst = out + (((long long)n * g.out_h + oy) * g.out_w + ox) * COUT + (lane & 3) * 2;
#pragma unroll
      for (int t8 = 0; t8 < 16; ++t8) {
        const int ch = t8 * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(dst + t8 * 8) =
            pack_bf16x2(bf16_round(acc[4 * t8 + 2 * h]) + bias[ch],
                        bf16_round(acc[4 * t8 + 2 * h + 1]) + bias[ch + 1]);
      }
    }
  }
}

template <bool PATCH>
int launch(const void* x, const void* ytab, const void* xtab, const void* w, const void* bias,
           void* out, const Geometry& g, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      resize_conv_hopper<PATCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = g.N * g.tiles_x * g.tiles_y;
  resize_conv_hopper<PATCH><<<min(n_tiles, sms), NTHREADS, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const Tap*>(ytab), static_cast<const Tap*>(xtab),
      static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (N, H, W, C) bf16, C a multiple of 128, 16-byte aligned;
// ytab / xtab: per tile row / column, the patch origin and the TH + 2 /
// TW + 2 halo taps (Tap, 16 bytes each; ops/output_tail._tile_taps at a
// tile of 16); w: the 9 * C / 64 B tiles of 128 x 64 in (chunk, tap)
// order, 128-byte swizzled; bias: fp32 (128,) holding bf16 values; out:
// contiguous (N, out_h, out_w, 128) bf16.  patch: every tile's taps lie
// within PATCH_H x PATCH_W source pixels (the wrapper checks), else 0.
extern "C" int vda_resize_conv(const void* x, const void* ytab, const void* xtab, const void* w,
                               const void* bias, void* out, int N, int H, int W, int C, int out_h,
                               int out_w, int patch, void* stream) {
  if (C % 128 || N < 1 || out_h < 1 || out_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{N, H, W, C, out_h, out_w, (out_w + TW - 1) / TW, (out_h + TH - 1) / TH};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return patch ? launch<true>(x, ytab, xtab, w, bias, out, g, st)
               : launch<false>(x, ytab, xtab, w, bias, out, g, st);
}
