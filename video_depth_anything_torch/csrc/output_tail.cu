// The fused output tail of the DPT head, one output tile per CTA.
//
// Replaces video_depth_anything_tpu/ops/pallas_output_stack.py:_tail_kernel
// (via fused_output_tail).  On output_conv1's map x (N, H, W, C) bf16 it
// computes, for the output tile of TH x TW pixels of one frame,
//   bilinear align_corners resize to (out_h, out_w), fp32 arithmetic,
//     rounded to bf16 once after both passes
//   -> conv3x3 C -> 32 (fp32 accumulate, rounded to bf16) + b1 (bf16) -> ReLU
//   -> conv1x1 32 -> 1 (fp32 products of bf16 values, fp32 sum, rounded to
//      bf16) + b2 (bf16) -> ReLU
// and writes only the 1-channel depth: the resized C-channel map never
// touches device memory.  The rounding points are those of _tail_kernel
// and of the plain chain (F.interpolate, then cuDNN's conv with the bias
// added in bf16 after it).
//
// Bound on the H100: tensor-core FLOPs.  The conv3x3 costs 2*9*C*32 =
// 73,728 FLOP per output pixel; vitl at 518^2 (32 frames) does 633 GFLOP
// (0.64 ms at 989 TFLOP/s) against ~735 MB of input and output (0.22 ms).
// Design:
// - The resized tile plus its 1-pixel conv halo, (TH+2) x (TW+2) x C bf16
//   (92 KB with padded 272-byte pixel rows), is computed straight from the
//   bf16 input into shared memory: four 16-byte tap loads per 8 channels,
//   fp32 lerp with host-built fp32 tap tables (the same source-index
//   arithmetic as _vertical_tables), zero outside the map.
// - The conv3x3 is an implicit GEMM on mma.sync m16n8k16 (bf16 in, fp32
//   accumulate): M = the tile's pixels (one output row of 32 per warp),
//   N = 32, K = 9 * C.  A comes from the tile by ldmatrix at the tap's
//   (dy, dx) offset; B (w1, 72 KB) streams through L1/L2 in the host-built
//   fragment order of Kernel C (one 16-byte load per lane per two k-steps).
// - Bias, ReLU, the 1x1, its bias and ReLU run in the epilogue on the
//   accumulators: the 4 lanes that share a pixel hold its 32 channels and
//   reduce them with two shuffles.
// The TPU's frame packing into lanes, hi/lo bf16 split of the fp32 weights
// (an MXU workaround), banded horizontal GEMM chunks and row-block DMA
// spans are not carried over.  wgmma, TMA and w1 in shared memory are
// later work.
#include "common.cuh"

namespace {

constexpr int MID = 32;      // output_conv2's hidden width
constexpr int TH = 8;        // output rows per CTA, one per warp
constexpr int TW = 32;       // output columns per CTA, two m16 tiles per warp
constexpr int NTHREADS = TH * 32;
constexpr int HH = TH + 2;   // resized tile rows with the conv halo
constexpr int HW = TW + 2;   // resized tile columns with the conv halo

template <int C>
__global__ void __launch_bounds__(NTHREADS, 2) output_tail_kernel(
    const bf16* __restrict__ x, const int* __restrict__ yi, const float* __restrict__ yw,
    const int* __restrict__ xi, const float* __restrict__ xw, const bf16* __restrict__ w1,
    const float* __restrict__ epi, bf16* __restrict__ out, int H, int W, int out_h,
    int out_w) {
  constexpr int LDS = C + 8;        // padded pixel row: conflict-free ldmatrix
  constexpr int KBT = 9 * C / 32;   // k-blocks of w1 in fragment order
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);

  const int n = blockIdx.z, oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const bf16* xn = x + (long long)n * H * W * C;

  // 1. resized tile + halo, 8 channels (16 bytes) per item
  for (int i = tid; i < HH * HW * (C / 8); i += NTHREADS) {
    const int p = i / (C / 8), c = (i % (C / 8)) * 8;
    const int oy = oy0 - 1 + p / HW, ox = ox0 - 1 + p % HW;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (oy >= 0 && oy < out_h && ox >= 0 && ox < out_w) {
      const int y0 = yi[oy], y1 = yi[out_h + oy], x0 = xi[ox], x1 = xi[out_w + ox];
      const float wy0 = yw[oy], wy1 = yw[out_h + oy], wx0 = xw[ox], wx1 = xw[out_w + ox];
      const uint4 a = *reinterpret_cast<const uint4*>(xn + ((long long)y0 * W + x0) * C + c);
      const uint4 b = *reinterpret_cast<const uint4*>(xn + ((long long)y0 * W + x1) * C + c);
      const uint4 d = *reinterpret_cast<const uint4*>(xn + ((long long)y1 * W + x0) * C + c);
      const uint4 e = *reinterpret_cast<const uint4*>(xn + ((long long)y1 * W + x1) * C + c);
      const bf162* a2 = reinterpret_cast<const bf162*>(&a);
      const bf162* b2 = reinterpret_cast<const bf162*>(&b);
      const bf162* d2 = reinterpret_cast<const bf162*>(&d);
      const bf162* e2 = reinterpret_cast<const bf162*>(&e);
      uint32_t* r2 = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(a2[j]), fb = __bfloat1622float2(b2[j]);
        const float2 fd = __bfloat1622float2(d2[j]), fe = __bfloat1622float2(e2[j]);
        const float lo = wy0 * (wx0 * fa.x + wx1 * fb.x) + wy1 * (wx0 * fd.x + wx1 * fe.x);
        const float hi = wy0 * (wx0 * fa.y + wx1 * fb.y) + wy1 * (wx0 * fd.y + wx1 * fe.y);
        r2[j] = pack_bf16x2(lo, hi);
      }
    }
    *reinterpret_cast<uint4*>(tile + p * LDS + c) = r;
  }
  __syncthreads();

  // 2. conv3x3 as an implicit GEMM: warp w owns output row w of the tile
  const int warp = tid >> 5, lane = tid & 31;
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const bf16* arow = tile + ((warp + tap / 3) * HW + tap % 3 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
    for (int kb = 0; kb < C / 32; ++kb) {
      uint4 bw[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        bw[t] = __ldg(reinterpret_cast<const uint4*>(
            w1 + ((long long)t * KBT + tap * (C / 32) + kb) * 256 + lane * 8));
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldmatrix_x4(af[m][0], af[m][1], af[m][2], af[m][3],
                      arow + m * 16 * LDS + kb * 32 + ks * 16);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma_bf16_16816(acc[m][t], af[m], ks ? bw[t].z : bw[t].x, ks ? bw[t].w : bw[t].y);
      }
    }
  }

  // 3. epilogue: + b1, ReLU, 1x1 (reduced over the 4 lanes of a pixel),
  //    + b2, ReLU; epi = [b1 (32), w2 (32), b2], bf16 values in fp32
  const int oy = oy0 + warp;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = t * 8 + (lane & 3) * 2 + e;
          const float z = fmaxf(bf16_round(bf16_round(acc[m][t][2 * hf + e]) + epi[ch]), 0.f);
          s = fmaf(z, epi[MID + ch], s);
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int ox = ox0 + m * 16 + (lane >> 2) + hf * 8;
      if ((lane & 3) == 0 && oy < out_h && ox < out_w)
        out[((long long)n * out_h + oy) * out_w + ox] =
            __float2bfloat16_rn(fmaxf(bf16_round(bf16_round(s) + epi[2 * MID]), 0.f));
    }
}

template <int C>
int launch(const bf16* x, const int* yi, const float* yw, const int* xi, const float* xw,
           const bf16* w1, const float* epi, bf16* out, int N, int H, int W, int out_h,
           int out_w, cudaStream_t stream) {
  const int smem = HH * HW * (C + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(output_tail_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((out_w + TW - 1) / TW, (out_h + TH - 1) / TH, N);
  output_tail_kernel<C><<<grid, NTHREADS, smem, stream>>>(x, yi, yw, xi, xw, w1, epi, out, H, W,
                                                         out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (N, H, W, C) bf16; yi/yw: (2, out_h) int32 / fp32 row taps
// [lo; hi] and weights [w_lo; w_hi], xi/xw the same for columns; w1 in
// fragment order (K = 9 * C in (dy, dx, c) order, N = 32); epi: fp32
// [b1 (32), w2 (32), b2]; out: contiguous (N, out_h, out_w) bf16.
extern "C" int vda_output_tail(const void* x, const void* yi, const void* yw, const void* xi,
                               const void* xw, const void* w1, const void* epi, void* out, int N,
                               int H, int W, int C, int out_h, int out_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* yib = static_cast<const int*>(yi);
  const float* ywb = static_cast<const float*>(yw);
  const int* xib = static_cast<const int*>(xi);
  const float* xwb = static_cast<const float*>(xw);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const float* ep = static_cast<const float*>(epi);
  bf16* o = static_cast<bf16*>(out);
  // vitl's head width; the JAX gate sends no other width to the kernel.
  switch (C) {
    case 128: return launch<128>(xb, yib, ywb, xib, xwb, w1b, ep, o, N, H, W, out_h, out_w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
