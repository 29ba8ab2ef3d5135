// Fused bilinear resize -> conv3x3 + bias, one output tile per CTA.
//
// Replaces video_depth_anything_tpu/ops/pallas_resize_conv.py:
// _resize_conv_kernel (via fused_resize_conv / try_fused_resize_conv).  On
// x (N, H, W, C) bf16, C a multiple of 128, it computes for the output
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
// (0.32 ms at 3.35 TB/s).
// Design (csrc/output_tail.cu's, with a 128-wide output):
// - The K = 9 * C dimension is walked in channel chunks of 128: per chunk
//   the resized tile plus its 1-pixel conv halo, (TH+2) x (TW+2) x 128
//   bf16 (92.5 KB with 272-byte pixel rows, conflict-free for ldmatrix),
//   is computed straight from the bf16 input into shared memory (four
//   16-byte tap loads per 8 channels, fp32 lerp with host-built tap tables,
//   zero outside the map), then consumed by the GEMM.  A full-channel tile
//   at C = 256 would take 180 KB and leave no room to grow the tile.
// - The conv is an implicit GEMM on mma.sync m16n8k16 (bf16 in, fp32
//   accumulate): M = the tile's pixels, N = 128, K = 9 * C.  Each of the 8
//   warps owns two output rows of 32 pixels and half of the 128 channels,
//   so 4 x 8 m16n8 accumulators (128 fp32 registers per lane).  A comes
//   from the tile by ldmatrix at the tap's (dy, dx) offset; B (the weights,
//   9 * C * 128 bf16) streams through L1/L2 in Kernel C's fragment order
//   (ops/motion_module._frag), one 8-byte load per lane per n8 tile and
//   k-step (the 16-byte load of both k-steps took the kernel to 255
//   registers and a spill).
// - The epilogue rounds each accumulator to bf16, adds the bias (bf16
//   values) and rounds again.
// The TPU kernel's hi/lo bf16 split of the interpolation weights (an MXU
// workaround), its banded horizontal GEMM chunks and its row-block DMA
// spans are not carried over.  wgmma, TMA, weights in shared memory and a
// double-buffered chunk loop are later work.
#include "common.cuh"

namespace {

constexpr int COUT = 128;
constexpr int CC = 128;      // channels per chunk of the K loop
constexpr int TH = 8;        // output rows per CTA
constexpr int TW = 32;       // output columns per CTA
constexpr int NTHREADS = 256;
constexpr int HH = TH + 2;   // resized tile rows with the conv halo
constexpr int HW = TW + 2;   // resized tile columns with the conv halo
constexpr int LDS = CC + 8;  // padded pixel row: conflict-free ldmatrix
constexpr int SMEM = HH * HW * LDS * 2;

__global__ void __launch_bounds__(NTHREADS, 1) resize_conv_kernel(
    const bf16* __restrict__ x, const int* __restrict__ yi, const float* __restrict__ yw,
    const int* __restrict__ xi, const float* __restrict__ xw, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C, int out_h,
    int out_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);

  const int n = blockIdx.z, oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ry = (warp >> 1) * 2;  // the warp's first output row in the tile
  const int half = warp & 1;       // the warp's half of the 128 channels
  const int kbt = 9 * C / 32;      // k-blocks of w in fragment order
  const bf16* xn = x + (long long)n * H * W * C;

  float acc[2][2][8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][m][t][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk's GEMM is done with the tile
    // 1. resized tile + halo of channels c0..c0+127, 8 channels per item
    for (int i = tid; i < HH * HW * (CC / 8); i += NTHREADS) {
      const int p = i / (CC / 8), c = (i % (CC / 8)) * 8;
      const int oy = oy0 - 1 + p / HW, ox = ox0 - 1 + p % HW;
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (oy >= 0 && oy < out_h && ox >= 0 && ox < out_w) {
        const int y0 = yi[oy], y1 = yi[out_h + oy], x0 = xi[ox], x1 = xi[out_w + ox];
        const float wy0 = yw[oy], wy1 = yw[out_h + oy], wx0 = xw[ox], wx1 = xw[out_w + ox];
        const bf16* src = xn + c0 + c;
        const uint4 a = *reinterpret_cast<const uint4*>(src + ((long long)y0 * W + x0) * C);
        const uint4 b = *reinterpret_cast<const uint4*>(src + ((long long)y0 * W + x1) * C);
        const uint4 d = *reinterpret_cast<const uint4*>(src + ((long long)y1 * W + x0) * C);
        const uint4 e = *reinterpret_cast<const uint4*>(src + ((long long)y1 * W + x1) * C);
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

    // 2. this chunk's part of the conv as an implicit GEMM
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* arow = tile + ((ry + tap / 3) * HW + tap % 3 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int kb = 0; kb < CC / 32; ++kb) {
        const int kblk = tap * (C / 32) + c0 / 32 + kb;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          // this k-step's half of each lane's 16-byte fragment: 16 registers
          uint2 bw[8];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            bw[t] = __ldg(reinterpret_cast<const uint2*>(
                w + ((long long)(half * 8 + t) * kbt + kblk) * 256 + lane * 8 + ks * 4));
          uint32_t af[2][2][4];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int m = 0; m < 2; ++m)
              ldmatrix_x4(af[r][m][0], af[r][m][1], af[r][m][2], af[r][m][3],
                          arow + (r * HW + m * 16) * LDS + kb * 32 + ks * 16);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int t = 0; t < 8; ++t)
                mma_bf16_16816(acc[r][m][t], af[r][m], bw[t].x, bw[t].y);
        }
      }
    }
  }

  // 3. epilogue: round, + bias (bf16 values in fp32), round, store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int oy = oy0 + ry + r;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ox = ox0 + m * 16 + (lane >> 2) + hf * 8;
        if (oy >= out_h || ox >= out_w) continue;
        bf16* dst = out + (((long long)n * out_h + oy) * out_w + ox) * COUT;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int ch = half * 64 + t * 8 + (lane & 3) * 2;
          *reinterpret_cast<uint32_t*>(dst + ch) =
              pack_bf16x2(bf16_round(acc[r][m][t][2 * hf]) + bias[ch],
                          bf16_round(acc[r][m][t][2 * hf + 1]) + bias[ch + 1]);
        }
      }
  }
}

}  // namespace

// x: contiguous (N, H, W, C) bf16, C a multiple of 128; yi/yw: (2, out_h)
// int32 / fp32 row taps [lo; hi] and weights [w_lo; w_hi], xi/xw the same
// for columns; w in fragment order (K = 9 * C in (dy, dx, c) order,
// N = 128); bias: fp32 (128,) holding bf16 values; out: contiguous
// (N, out_h, out_w, 128) bf16.
extern "C" int vda_resize_conv(const void* x, const void* yi, const void* yw, const void* xi,
                               const void* xw, const void* w, const void* bias, void* out, int N,
                               int H, int W, int C, int out_h, int out_w, void* stream) {
  if (C % CC) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(resize_conv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((out_w + TW - 1) / TW, (out_h + TH - 1) / TH, N);
  resize_conv_kernel<<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(yi), static_cast<const float*>(yw),
      static_cast<const int*>(xi), static_cast<const float*>(xw), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, C, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
