// Kernel C on fp32 operands: one whole motion module (TemporalModule) per
// block of locations, under --fp32.
//
// Replaces video_depth_anything_tpu/ops/pallas_motion.py:_motion_kernel
// (via fused_motion_module) where the JAX package runs it on fp32 inputs:
// its gate and plan (_plan_s_blk) look at shapes alone, and its body
// computes in x's dtype (bt = x_ref.dtype), with the erf GELU where bt is
// not bf16.  Per CTA: one batch element and L = 32 / T consecutive
// locations, 32 rows of C channels, location major (row r = l * T + t).
// The CTA computes, all in fp32 with FFMA on the CUDA cores:
//   GroupNorm apply (statistics folded outside, as _gn_fold does) -> proj_in
//   -> 2 x [LayerNorm, +APE, q/k/v, attention over the T frames per
//           (location, head), out proj + bias, residual]
//   -> LayerNorm -> GEGLU feed-forward (erf GELU) -> residual -> proj_out
//   -> + x
// with every activation in shared memory: only x (read twice: at the start
// and for the outer residual), the folded GroupNorm, the weights and the
// output touch device memory.  C in {64, 128, 192, 256, 384}, 8 heads, T in
// {8, 16, 32}.
//
// Bound on the H100: operations.  44 * C^2 + 8 * T * C FLOP per token on
// the CUDA cores' fp32 FMA (67 TFLOP/s): at vits m3 518^2 (C = 64, 175,232
// tokens) 3.2e10 FLOP, 0.48 ms, against 90 MB of x and output (0.03 ms).
//
// Design (a simple kernel that is right; speed is later work).
// - Weights: one fp32 buffer of 22 C^2 values that the host lays out once
//   (ops/motion_module.weight_matrices_f32, cached by TemporalModule under
//   the fp32 dtype), each product's matrix row-major (K rows x N columns,
//   y = x @ w): proj_in; per attention block q|k|v interleaved by chunk
//   (the q, k and v columns of one chunk of whole heads side by side) and
//   the out projection; w1 interleaved by 64-column hidden chunk (h, then
//   its gate); w2; proj_out.  A product streams its matrix through shared
//   memory 16 rows at a time (coalesced 16-byte loads; every row of the
//   CTA shares the copy).
// - Products: a thread owns 4 rows x ceil(N / 32) columns (column lane +
//   32 i) of the 32 x N result, in registers; the activation values are
//   warp-wide broadcasts, the weight values conflict-free reads.
// - Three 32 x C activation buffers (y the residual stream, h the norm
//   outputs, o the attention output) with rows of C + 4 floats, one for a
//   chunk's q | k | v (then the feed-forward's 64-column activation), and
//   the 16-row weight stage: 192.5 KB at C = 384, one CTA an SM.
// - Attention by chunks of whole heads (at most 64 channels): the chunk's
//   q, k and v in one product, then one thread per (query row, head) with
//   its T scores in registers, an exact softmax (max, exp2, sum) and the
//   output written into o.  Then o @ w_o + b_o is added to y.
// - The feed-forward runs in 64-column hidden chunks: a 32 x 128 product
//   (h and gate columns, so a thread holds each h column beside its gate),
//   the GEGLU in registers, then the chunk's w2 rows accumulate into a 32
//   x C register accumulator over all chunks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows a CTA
constexpr int kKC = 16;    // weight rows a stage
constexpr int kHeads = 8;

struct Params {
  const float* x;
  const float* gna;
  const float* gnb;
  const float* pe;
  const float* w;
  const float* b_in;
  const float* ln_s;
  const float* ln_b;
  const float* bo;
  const float* b1;
  const float* b2;
  const float* b_out;
  float* out;
  int B, T, S;
  float scale_log2, ln_eps;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C>
struct Plan {
  static constexpr int D = C / kHeads;
  static constexpr int NCH = D * (64 / D);  // channels of a chunk: whole heads, <= 64
  static constexpr int QN = 3 * NCH;        // its q | k | v columns
  static constexpr int AS = C + 4;          // activation row stride
  static constexpr int QS = QN + 4;         // chunk row stride
  static constexpr int WN = cmax(cmax(C, QN), 128);  // widest staged product
  static constexpr int NC = C / 32;         // columns a thread: a C-wide product
  static constexpr int NQ = (QN + 31) / 32;  // columns a thread: a chunk's q | k | v
  // offsets (floats) of the matrices in the weight buffer
  static constexpr long long OFF_IN = 0;
  static constexpr long long OFF_BLK = (long long)C * C;  // + i * 4 C^2: q|k|v (C x 3C), then w_o
  static constexpr long long OFF_FF = 9LL * C * C;        // w1 interleaved, C x 8C
  static constexpr long long OFF_W2 = 17LL * C * C;       // 4C x C
  static constexpr long long OFF_OUT = 21LL * C * C;      // C x C
  static constexpr int SMEM_FLOATS = 3 * kRows * AS + kRows * QS + kKC * WN;
};

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
}

// acc[r][i] += sum_k A[4 * warp + r][k] * W[k][lane + 32 i] over K rows:
// A in shared memory (row stride lda), W in device memory (row stride ldw,
// already offset to the first column), N columns (a multiple of 4).
// Starts with a barrier, so the caller's writes of A are visible.
template <int NC>
__device__ __forceinline__ void gemm(float (&acc)[4][NC], const float* A, int lda, int K,
                                     const float* __restrict__ W, int ldw, int N, float* wbuf) {
  const int tid = threadIdx.x, rg = tid >> 5, lane = tid & 31;
  const int n4 = N / 4;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();
    for (int i = tid; i < kKC * n4; i += kThreads) {
      const int kk = i / n4, c = (i % n4) * 4;
      *reinterpret_cast<float4*>(wbuf + kk * N + c) =
          __ldg(reinterpret_cast<const float4*>(W + (long long)(k0 + kk) * ldw + c));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A[(rg * 4 + r) * lda + k0 + kk];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = lane + 32 * i;
        const float w = col < N ? wbuf[kk * N + col] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][i] = fmaf(a[r], w, acc[r][i]);
      }
    }
  }
}

// dst = LayerNorm(src) (+ the APE row of the row's frame when pe is given):
// fp32 mean and E[x^2] - mean^2 (clamped at 0), as ops/motion_module._ln.
template <int C>
__device__ __forceinline__ void layer_norm(const float* src, float* dst, const float* g,
                                           const float* bias, const float* pe, int T, float eps) {
  constexpr int AS = Plan<C>::AS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < 4; ++rr) {
    const int r = warp * 4 + rr;
    const float* yr = src + r * AS;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = yr[c];
      sum += v;
      sq = fmaf(v, v, sq);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    const float mean = sum / C;
    const float inv = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
    const float* per = pe ? pe + (r % T) * C : nullptr;
    for (int c = lane; c < C; c += 32) {
      float v = (yr[c] - mean) * (inv * g[c]) + bias[c];
      if (per) v += per[c];
      dst[r * AS + c] = v;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) motion_f32(const Params p) {
  using P = Plan<C>;
  constexpr int AS = P::AS, QS = P::QS, NC = P::NC, D = P::D, NCH = P::NCH;
  extern __shared__ __align__(16) float smem[];
  float* sy = smem;                  // residual stream
  float* sh = sy + kRows * AS;       // norm outputs
  float* so = sh + kRows * AS;       // attention output
  float* sq = so + kRows * AS;       // a chunk's q | k | v; the FF activation
  float* wb = sq + kRows * QS;       // staged weight rows
  const int T = p.T, L = kRows / T;
  const int tid = threadIdx.x, rg = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, s0 = blockIdx.x * L;

  // GroupNorm apply: h = x * gna[b, t] + gnb[b, t]; locations past S are zero rows
  for (int i = tid; i < kRows * C / 4; i += kThreads) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const int t = r % T, s = s0 + r / T;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < p.S)
      xv = *reinterpret_cast<const float4*>(p.x + ((long long)(b * T + t) * p.S + s) * C + c);
    const float4 ga = *reinterpret_cast<const float4*>(p.gna + (long long)(b * T + t) * C + c);
    const float4 gb = *reinterpret_cast<const float4*>(p.gnb + (long long)(b * T + t) * C + c);
    *reinterpret_cast<float4*>(sh + r * AS + c) =
        make_float4(fmaf(xv.x, ga.x, gb.x), fmaf(xv.y, ga.y, gb.y), fmaf(xv.z, ga.z, gb.z),
                    fmaf(xv.w, ga.w, gb.w));
  }

  {  // proj_in
    float acc[4][NC];
    zero(acc);
    gemm(acc, sh, AS, C, p.w + P::OFF_IN, C, C, wb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = lane + 32 * i;
        sy[(rg * 4 + r) * AS + col] = acc[r][i] + p.b_in[col];
      }
  }

  for (int blk = 0; blk < 2; ++blk) {
    __syncthreads();
    layer_norm<C>(sy, sh, p.ln_s + blk * C, p.ln_b + blk * C, p.pe, T, p.ln_eps);
    const float* wqkv = p.w + P::OFF_BLK + (long long)blk * 4 * C * C;
    for (int ch = 0; ch < C / NCH; ++ch) {
      float acc[4][P::NQ];
      zero(acc);
      gemm(acc, sh, AS, C, wqkv + ch * P::QN, 3 * C, P::QN, wb);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < P::NQ; ++i) {
          const int col = lane + 32 * i;
          if (col < P::QN) sq[(rg * 4 + r) * QS + col] = acc[r][i];
        }
      __syncthreads();
      // one thread per (query row, head of the chunk): a warp is one head
      const int j = tid >> 5, rq = lane;
      if (j < NCH / D) {
        const int base = (rq / T) * T;  // the first row of the query's location
        const float* qr = sq + rq * QS + j * D;
        float s[32];
#pragma unroll
        for (int kf = 0; kf < 32; ++kf) {
          float dot = 0.f;
          if (kf < T) {
            const float* kr = sq + (base + kf) * QS + NCH + j * D;
#pragma unroll
            for (int e = 0; e < D; e += 4) {
              const float4 qx = *reinterpret_cast<const float4*>(qr + e);
              const float4 kx = *reinterpret_cast<const float4*>(kr + e);
              dot = fmaf(qx.x, kx.x, dot);
              dot = fmaf(qx.y, kx.y, dot);
              dot = fmaf(qx.z, kx.z, dot);
              dot = fmaf(qx.w, kx.w, dot);
            }
          }
          s[kf] = dot * p.scale_log2;
        }
        float m = s[0];
#pragma unroll
        for (int kf = 1; kf < 32; ++kf)
          if (kf < T) m = fmaxf(m, s[kf]);
        float l = 0.f;
#pragma unroll
        for (int kf = 0; kf < 32; ++kf) {
          s[kf] = kf < T ? exp2f(s[kf] - m) : 0.f;
          l += s[kf];
        }
        const float inv = 1.f / l;
        for (int e = 0; e < D; e += 4) {
          float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int kf = 0; kf < 32; ++kf) {
            if (kf < T) {
              const float4 vx =
                  *reinterpret_cast<const float4*>(sq + (base + kf) * QS + 2 * NCH + j * D + e);
              acc4.x = fmaf(s[kf], vx.x, acc4.x);
              acc4.y = fmaf(s[kf], vx.y, acc4.y);
              acc4.z = fmaf(s[kf], vx.z, acc4.z);
              acc4.w = fmaf(s[kf], vx.w, acc4.w);
            }
          }
          *reinterpret_cast<float4*>(so + rq * AS + ch * NCH + j * D + e) =
              make_float4(acc4.x * inv, acc4.y * inv, acc4.z * inv, acc4.w * inv);
        }
      }
    }
    {  // out projection and residual
      float acc[4][NC];
      zero(acc);
      gemm(acc, so, AS, C, wqkv + 3LL * C * C, C, C, wb);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int col = lane + 32 * i;
          sy[(rg * 4 + r) * AS + col] += acc[r][i] + p.bo[blk * C + col];
        }
    }
  }

  // feed-forward: LayerNorm, then 64-column hidden chunks of the GEGLU
  __syncthreads();
  layer_norm<C>(sy, sh, p.ln_s + 2 * C, p.ln_b + 2 * C, nullptr, T, p.ln_eps);
  float ff[4][NC];
  zero(ff);
  for (int f = 0; f < 4 * C / 64; ++f) {
    float g[4][4];
    zero(g);
    gemm(g, sh, AS, C, p.w + P::OFF_FF + f * 128, 8 * C, 128, wb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = lane + 32 * i, hcol = f * 64 + col;
        const float a = g[r][i] + p.b1[hcol];
        const float gt = g[r][i + 2] + p.b1[4 * C + hcol];
        sq[(rg * 4 + r) * QS + col] = a * (0.5f * gt * (1.f + erff(gt * 0.70710678118654752f)));
      }
    gemm(ff, sq, QS, 64, p.w + P::OFF_W2 + (long long)f * 64 * C, C, C, wb);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int col = lane + 32 * i;
      sy[(rg * 4 + r) * AS + col] += ff[r][i] + p.b2[col];
    }

  {  // proj_out, + x
    float acc[4][NC];
    zero(acc);
    gemm(acc, sy, AS, C, p.w + P::OFF_OUT, C, C, wb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rg * 4 + r, t = row % T, s = s0 + row / T;
      if (s >= p.S) continue;
      const long long off = ((long long)(b * T + t) * p.S + s) * C;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = lane + 32 * i;
        p.out[off + col] = acc[r][i] + p.b_out[col] + p.x[off + col];
      }
    }
  }
}

template <int C>
int launch(const Params& p, cudaStream_t st) {
  const int smem = Plan<C>::SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(motion_f32<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = kRows / p.T;
  dim3 grid((p.S + L - 1) / L, p.B);
  motion_f32<C><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, T, S, C) fp32; gna/gnb (B, T, C) fp32; pe (T', C) fp32, T' >=
// T; w the 22 C^2 fp32 weights (ops/motion_module.weight_matrices_f32);
// b_in, b2, b_out (C,), ln_s/ln_b (3, C), bo (2, C), b1 (8C,) fp32.
extern "C" int vda_motion_module_f32(const void* x, const void* gna, const void* gnb,
                                     const void* pe, const void* w, const void* b_in,
                                     const void* ln_s, const void* ln_b, const void* bo,
                                     const void* b1, const void* b2, const void* b_out, void* out,
                                     int B, int T, int S, int C, float scale, float ln_eps,
                                     void* stream) {
  if (T != 8 && T != 16 && T != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  Params p;
  p.x = static_cast<const float*>(x);
  p.gna = static_cast<const float*>(gna);
  p.gnb = static_cast<const float*>(gnb);
  p.pe = static_cast<const float*>(pe);
  p.w = static_cast<const float*>(w);
  p.b_in = static_cast<const float*>(b_in);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.bo = static_cast<const float*>(bo);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.T = T;
  p.S = S;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.ln_eps = ln_eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch<64>(p, st);
    case 128: return launch<128>(p, st);
    case 192: return launch<192>(p, st);
    case 256: return launch<256>(p, st);
    case 384: return launch<384>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
