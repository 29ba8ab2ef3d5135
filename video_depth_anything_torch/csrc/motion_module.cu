// Kernel C: one whole motion module (TemporalModule) per block of locations.
//
// Replaces video_depth_anything_tpu/ops/pallas_motion.py:_motion_kernel
// (via fused_motion_module).  Per CTA: one batch element and L = R / T
// consecutive spatial locations, i.e. R = T * L rows of C channels (row
// r = t * L + l).  The CTA computes
//   GroupNorm apply (statistics folded outside, as _gn_fold does) -> proj_in
//   -> 2 x [LayerNorm, +APE, q/k/v, attention over the T frames per
//           (location, head), out proj, residual]
//   -> LayerNorm -> GEGLU feed-forward -> residual -> proj_out -> + x
// with every activation in shared memory: only x (read twice: at the start
// and for the outer residual), the weights and the output touch device
// memory.  Values are rounded to bf16 where the TPU kernel rounds them (h,
// y, q, k, v, p, attention out, the FF activation, y after each residual).
//
// Bound on the H100: tensor-core FLOPs (~44*C^2 per token; vits m3 at 518^2
// for one window ~32 GFLOP, ~32 us) over bytes (~45 MB, ~13 us).  Design:
// - GEMMs run on mma.sync m16n8k16 (bf16 in, fp32 accumulate).  A comes
//   from shared memory by ldmatrix; B (the weights, <= 1.6 MB at C = 192)
//   streams through L2 in a host-prepared fragment order, so each lane
//   fetches its B fragments for two k-steps with one coalesced 16-byte
//   load.  Each warp computes 32x32 output units.  At C = 384 the weights
//   are 22 * C^2 bf16 = 6.5 MB, still inside the 50 MB L2.
// - The 2*4*C-wide GEGLU intermediate never exists in full: the FF runs in
//   four column chunks of width C, accumulating the second product in an
//   fp32 buffer that reuses the (dead) q/k space.
// - Attention: one warp per (location, head), lane t owns query frame t, so
//   the softmax row sits in one thread's registers.
// The TPU's block-diagonal weights, gunit and lane packing are not carried
// over.  wgmma/TMA and a weight ring in shared memory are later work.
#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int HEADS = 8;

struct Params {
  const bf16* x;
  const float* gna;
  const float* gnb;
  const bf16* pe;
  const bf16* w_in;
  const float* b_in;
  const float* ln_s;
  const float* ln_b;
  const bf16* wq;
  const bf16* wk;
  const bf16* wv;
  const bf16* wo;
  const float* bo;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* w_out;
  const float* b_out;
  bf16* out;
  int B, T, S;
  float scale, ln_eps;
};

// out[R x N] = A[R x K] (smem, row stride lda) @ W^T, W in fragment order:
// for n-tile nt (8 output columns) and k-block kb (32 inputs), 32 lanes x 8
// bf16 at W + (nt * Ktot / 32 + kb) * 256.  NB weight matrices share A
// (NB = 2 gives the GEGLU pair); the epilogue sees (row, col, values...).
template <int NB, typename Epi>
__device__ __forceinline__ void gemm(const bf16* sA, int lda, int R, int K, const bf16* W0,
                                     const bf16* W1, int nt0, int nt1, int Ktot, int kb0, int N,
                                     Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_blocks = N / 32, units = (R / 32) * n_blocks;
  const int kbt = Ktot / 32;
  for (int u = warp; u < units; u += NWARPS) {
    const int mb = u / n_blocks, nb = u % n_blocks;
    float acc[NB][2][4][4];
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[x][m][n][e] = 0.f;
    for (int kb = 0; kb < K / 32; ++kb) {
      uint4 bw[NB][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        bw[0][n] = __ldg(reinterpret_cast<const uint4*>(
            W0 + ((long long)(nt0 + nb * 4 + n) * kbt + kb0 + kb) * 256 + lane * 8));
        if (NB == 2)
          bw[NB - 1][n] = __ldg(reinterpret_cast<const uint4*>(
              W1 + ((long long)(nt1 + nb * 4 + n) * kbt + kb0 + kb) * 256 + lane * 8));
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldmatrix_x4(af[m][0], af[m][1], af[m][2], af[m][3],
                      sA + (mb * 32 + m * 16 + (lane & 15)) * lda + kb * 32 + ks * 16 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mma_bf16_16816(acc[x][m][n], af[m], ks ? bw[x][n].z : bw[x][n].x,
                             ks ? bw[x][n].w : bw[x][n].y);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = mb * 32 + m * 16 + (lane >> 2) + hf * 8;
          const int col = nb * 32 + n * 8 + (lane & 3) * 2;
          epi(row, col, acc[0][m][n][2 * hf], acc[0][m][n][2 * hf + 1],
              acc[NB - 1][m][n][2 * hf], acc[NB - 1][m][n][2 * hf + 1]);
        }
  }
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// dst = bf16(LN(src)) (+ APE row of the frame, rounded again), warp per row
template <int C>
__device__ void layer_norm(const bf16* src, bf16* dst, int ld, int R, int L, const float* sc,
                           const float* bi, const bf16* pe, float eps) {
  constexpr int NP = C / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NWARPS) {
    float2 v[NP];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      v[j] = ld2(src + r * ld + j * 64 + lane * 2);
      s1 += v[j].x + v[j].y;
      s2 += v[j].x * v[j].x + v[j].y * v[j].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
    const int t = r / L;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int c = j * 64 + lane * 2;
      float a = bf16_round((v[j].x - mean) * (inv * sc[c]) + bi[c]);
      float b = bf16_round((v[j].y - mean) * (inv * sc[c + 1]) + bi[c + 1]);
      if (pe != nullptr) {
        const float2 p = ld2(pe + t * C + c);
        a += p.x;
        b += p.y;
      }
      st2(dst + r * ld + c, a, b);
    }
  }
}

// frame attention per (location, head): q/k/v rows r = t * L + l
template <int C>
__device__ void frame_attention(const bf16* sQ, const bf16* sK, const bf16* sV, bf16* sO,
                                int ld, int T, int L, float scale) {
  constexpr int DH = C / HEADS;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  for (int task = warp; task < L * HEADS; task += NWARPS) {
    const int l = task / HEADS, col = (task % HEADS) * DH;
    if (t >= T) continue;
    float qf[DH];
#pragma unroll
    for (int i = 0; i < DH; i += 2) {
      const float2 f = ld2(sQ + (t * L + l) * ld + col + i);
      qf[i] = f.x;
      qf[i + 1] = f.y;
    }
    float sc[32];
    float mx = -INFINITY;
#pragma unroll
    for (int t2 = 0; t2 < 32; ++t2) {
      float acc = -INFINITY;
      if (t2 < T) {
        acc = 0.f;
        const bf16* kr = sK + (t2 * L + l) * ld + col;
#pragma unroll
        for (int i = 0; i < DH; i += 2) {
          const float2 f = ld2(kr + i);
          acc = fmaf(qf[i], f.x, acc);
          acc = fmaf(qf[i + 1], f.y, acc);
        }
        acc *= scale;
      }
      sc[t2] = acc;
      mx = fmaxf(mx, acc);
    }
    float sum = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < 32; ++t2) {
      sc[t2] = __expf(sc[t2] - mx);
      sum += sc[t2];
    }
    const float inv = 1.f / sum;
    float o[DH];
#pragma unroll
    for (int i = 0; i < DH; ++i) o[i] = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < 32; ++t2) {
      if (t2 < T) {
        const float p = bf16_round(sc[t2] * inv);
        const bf16* vr = sV + (t2 * L + l) * ld + col;
#pragma unroll
        for (int i = 0; i < DH; i += 2) {
          const float2 f = ld2(vr + i);
          o[i] = fmaf(p, f.x, o[i]);
          o[i + 1] = fmaf(p, f.y, o[i + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DH; i += 2) st2(sO + (t * L + l) * ld + col + i, o[i], o[i + 1]);
  }
}

template <int C, int R>
__global__ void __launch_bounds__(NTHREADS) motion_module_kernel(const Params p) {
  constexpr int LD = C + 8;
  constexpr int FF = 4 * C;
  static_assert(R % 32 == 0 && C % 64 == 0, "32-row GEMM units, 64-wide LayerNorm steps");
  static_assert(R * C * 4 <= 2 * R * LD * 2, "the FF accumulator must fit over q and k");
  static_assert(5 * R * LD * 2 <= 232448, "shared memory over the opt-in limit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sY = reinterpret_cast<bf16*>(smem_raw);
  bf16* sH = sY + R * LD;
  bf16* sQ = sH + R * LD;
  bf16* sK = sQ + R * LD;
  bf16* sV = sK + R * LD;
  float* sF = reinterpret_cast<float*>(sQ);  // FF accumulator, R x C fp32 over q and k
  bf16* sAct = sV;                            // one FF chunk, R x C

  const int T = p.T, S = p.S, L = R / T;
  const int b = blockIdx.y, s0 = blockIdx.x * L;
  const int tid = threadIdx.x;

  // GroupNorm apply with the folded per-(b, t, c) scale and shift
  for (int i = tid; i < R * (C / 8); i += NTHREADS) {
    const int r = i / (C / 8), cc = (i % (C / 8)) * 8;
    const int t = r / L, s = s0 + r % L;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) xv = *reinterpret_cast<const uint4*>(p.x + ((long long)(b * T + t) * S + s) * C + cc);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const float* a = p.gna + (long long)(b * T + t) * C + cc;
    const float* bb = p.gnb + (long long)(b * T + t) * C + cc;
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      st2(sH + r * LD + cc + j, __bfloat162float(xe[j]) * a[j] + bb[j],
          __bfloat162float(xe[j + 1]) * a[j + 1] + bb[j + 1]);
  }
  __syncthreads();

  gemm<1>(sH, LD, R, C, p.w_in, p.w_in, 0, 0, C, 0, C,
          [&](int r, int c, float v0, float v1, float, float) {
            st2(sY + r * LD + c, v0 + p.b_in[c], v1 + p.b_in[c + 1]);
          });
  __syncthreads();

  for (int i = 0; i < 2; ++i) {
    layer_norm<C>(sY, sH, LD, R, L, p.ln_s + i * C, p.ln_b + i * C, p.pe, p.ln_eps);
    __syncthreads();
    const long long wofs = (long long)i * C * C;
    auto store_q = [&](int r, int c, float v0, float v1, float, float) { st2(sQ + r * LD + c, v0, v1); };
    auto store_k = [&](int r, int c, float v0, float v1, float, float) { st2(sK + r * LD + c, v0, v1); };
    auto store_v = [&](int r, int c, float v0, float v1, float, float) { st2(sV + r * LD + c, v0, v1); };
    gemm<1>(sH, LD, R, C, p.wq + wofs, p.wq + wofs, 0, 0, C, 0, C, store_q);
    gemm<1>(sH, LD, R, C, p.wk + wofs, p.wk + wofs, 0, 0, C, 0, C, store_k);
    gemm<1>(sH, LD, R, C, p.wv + wofs, p.wv + wofs, 0, 0, C, 0, C, store_v);
    __syncthreads();
    frame_attention<C>(sQ, sK, sV, sH, LD, T, L, p.scale);
    __syncthreads();
    const float* bo = p.bo + i * C;
    gemm<1>(sH, LD, R, C, p.wo + wofs, p.wo + wofs, 0, 0, C, 0, C,
            [&](int r, int c, float v0, float v1, float, float) {
              const float2 y = ld2(sY + r * LD + c);
              st2(sY + r * LD + c, y.x + v0 + bo[c], y.y + v1 + bo[c + 1]);
            });
    __syncthreads();
  }

  // GEGLU feed-forward in 4 column chunks of width C
  layer_norm<C>(sY, sH, LD, R, L, p.ln_s + 2 * C, p.ln_b + 2 * C, nullptr, p.ln_eps);
  for (int i = tid; i < R * C; i += NTHREADS) sF[i] = 0.f;
  __syncthreads();
  for (int j0 = 0; j0 < FF; j0 += C) {
    gemm<2>(sH, LD, R, C, p.w1, p.w1, j0 / 8, (FF + j0) / 8, C, 0, C,
            [&](int r, int c, float h0, float h1, float g0, float g1) {
              const float hh0 = bf16_round(h0 + p.b1[j0 + c]);
              const float hh1 = bf16_round(h1 + p.b1[j0 + c + 1]);
              const float gg0 = bf16_round(g0 + p.b1[FF + j0 + c]);
              const float gg1 = bf16_round(g1 + p.b1[FF + j0 + c + 1]);
              const float k0 = 0.7978845608028654f, k1 = 0.044715f;
              const float ge0 = bf16_round(0.5f * gg0 * (1.f + tanhf(k0 * (gg0 + k1 * gg0 * gg0 * gg0))));
              const float ge1 = bf16_round(0.5f * gg1 * (1.f + tanhf(k0 * (gg1 + k1 * gg1 * gg1 * gg1))));
              st2(sAct + r * LD + c, hh0 * ge0, hh1 * ge1);
            });
    __syncthreads();
    gemm<1>(sAct, LD, R, C, p.w2, p.w2, 0, 0, FF, j0 / 32, C,
            [&](int r, int c, float v0, float v1, float, float) {
              sF[r * C + c] += v0;
              sF[r * C + c + 1] += v1;
            });
    __syncthreads();
  }
  for (int i = tid; i < R * C / 2; i += NTHREADS) {
    const int r = (2 * i) / C, c = (2 * i) % C;
    const float2 y = ld2(sY + r * LD + c);
    st2(sY + r * LD + c, y.x + sF[r * C + c] + p.b2[c], y.y + sF[r * C + c + 1] + p.b2[c + 1]);
  }
  __syncthreads();

  // proj_out + outer residual straight to device memory
  gemm<1>(sY, LD, R, C, p.w_out, p.w_out, 0, 0, C, 0, C,
          [&](int r, int c, float v0, float v1, float, float) {
            const int t = r / L, s = s0 + r % L;
            if (s >= S) return;
            const long long g = ((long long)(b * T + t) * S + s) * C + c;
            const float2 x = ld2(p.x + g);
            st2(p.out + g, v0 + p.b_out[c] + x.x, v1 + p.b_out[c + 1] + x.y);
          });
}

template <int C, int R>
int launch(const Params& p, cudaStream_t stream) {
  if (R % p.T) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 5 * R * (C + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(motion_module_kernel<C, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int L = R / p.T;
  dim3 grid((p.S + L - 1) / L, p.B);
  motion_module_kernel<C, R><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: contiguous (B, T, S, C) bf16; gna/gnb: (B, T, C) fp32; pe: (T, C)
// bf16; weights in fragment order (see gemm), biases and LN params fp32.
// T must divide the CTA's row count (T in {8, 16, 32}); 8 heads.
extern "C" int vda_motion_module(
    const void* x, const void* gna, const void* gnb, const void* pe, const void* w_in,
    const void* b_in, const void* ln_s, const void* ln_b, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* bo, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* w_out, const void* b_out, void* out, int B,
    int T, int S, int C, float scale, float ln_eps, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.gna = static_cast<const float*>(gna);
  p.gnb = static_cast<const float*>(gnb);
  p.pe = static_cast<const bf16*>(pe);
  p.w_in = static_cast<const bf16*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.wq = static_cast<const bf16*>(wq);
  p.wk = static_cast<const bf16*>(wk);
  p.wv = static_cast<const bf16*>(wv);
  p.wo = static_cast<const bf16*>(wo);
  p.bo = static_cast<const float*>(bo);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.w_out = static_cast<const bf16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.T = T;
  p.S = S;
  p.scale = scale;
  p.ln_eps = ln_eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The widths the gate sends here: vits (m0: 192; m1-m3 at the gate's
  // sizes: 64), vitb (m2/m3: 128; m0 on 16:9 frames: 384) and vitl's m2/m3
  // (256).  Shared memory is 5 * R * (C + 8) * 2 bytes, and the fp32 FF
  // accumulator (R * C * 4) must fit over the q/k buffers (2 * R * (C + 8)
  // * 2): C = 128 at R = 128 takes 174,080 B (accumulator 64 KB over 68
  // KB); C = 256 at R = 64 165 KB (64 KB over 66 KB); C = 384 at R = 64
  // would take 250,880 B, over the 232,448 B a block may opt into, so it
  // runs R = 32 (one location of 32 frames, 125,440 B; 48 KB over 49 KB):
  // each GEMM then has 12 32x32 units for the 8 warps.
  switch (C) {
    case 64: return launch<64, 128>(p, st);
    case 128: return launch<128, 128>(p, st);
    case 192: return launch<192, 64>(p, st);
    case 256: return launch<256, 64>(p, st);
    case 384: return launch<384, 32>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
