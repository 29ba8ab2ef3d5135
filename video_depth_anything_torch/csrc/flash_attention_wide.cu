// Kernel A's forward at the head widths past D = 192 that its JAX gate
// admits: D = 320, 448, 576, ... (a multiple of 64, not of 128), in bf16
// (vda_flash_attention_wide) and in fp32 (vda_flash_attention_wide_f32)
// from one source templated on the element type.
//
// Replaces video_depth_anything_tpu/ops/pallas_attention.py:
// _flash_kernel_single (the whole-row kernel, padded N <= 2048) and
// _flash_kernel / _flash_kernel_fast (the blocked 512-key kernels past
// that), which spatial_flash_attention runs at every D != 64 that
// try_spatial_attention admits.  It computes what they compute:
// softmax(q k^T D^-1/2) v per (batch, head) on (B, N, H, D) operands that
// may be strided views of the fused qkv projection, fp32 scores, softmax
// and accumulate; in bf16 p is rounded to bf16 before P V (as in
// flash_attention_plain), in fp32 it stays fp32 and both products are
// fp32-accurate (3xTF32).  Exact (a running max) or FAST (the ':fast'
// no-max softmax, exact while the scaled logits stay inside fp32's exp2
// domain, about +-88, as at D = 64 and 192).  Any N >= 1; the zero-filled
// pad keys of the ragged last key tile are masked to -inf, pad query rows
// are computed on zeros and never stored.  No log-sum-exp: the JAX VJP at
// D != 64 is the dense einsum backward (pallas_attention.py:490-523), so
// no backward kernel reads one.  The TPU kernels' ones-column row sum
// (_flash_forward, :533-548) is a VPU workaround and is not carried over.
//
// Bound on the H100: operations.  The dense work is 4 N^2 D H B FLOP (at
// 989 TFLOP/s in bf16; in fp32 three TF32 products each at 495).  This
// plan recomputes S once for every output slice (below), so it does
// (2 N^2 D ceil(D / 192) + 2 N^2 D) H B: 1.5x the dense work at D = 320,
// 2x at 448, 6x at 1984.
//
// Design.  What D = 64's and 192's wgmma kernels keep resident does not fit
// here: a 64-row warpgroup holding a whole O row block needs 64 D / 128
// fp32 accumulators a thread (160 at D = 320, 992 at D = 1984), and a
// resident Q tile of 64 x D bf16 is 40 KB at D = 320 and 248 KB at D =
// 1984, past the 227 KB a block may have.  Nothing in the domain caps D,
// so nothing here grows with it:
// - A CTA is 64 query rows of one (b, h) and one slice of O: at most three
//   64-column panels (192 columns; the last slice takes what is left, e.g.
//   D = 320 is slices of 3 and 2 panels).  Four warps of 16 query rows
//   each; a thread keeps the slice's 96 fp32 accumulators, as at D = 192.
//   Grid: (query blocks x slices, B H), the slices of one query block
//   adjacent so that they share Q and K in the L2.
// - For each 64-key tile, S = sum over the D / 64 panels p of Q[:, p]
//   K[:, p]^T, then the online softmax (the running max, rescale by
//   exp2(m_old - m_new); FAST keeps m = 0), then O_slice += P V[:, slice].
//   A CTA's work is a flat sequence of steps: per key tile, D / 64 steps
//   that each load a Q panel and a K panel (64 x 64 each), then one step a
//   V panel of the slice.  Every step's tiles go through one cp.async ring
//   of kStages buffers (two 64 x 64 tiles each, rows padded by 16 bytes
//   against bank conflicts), so shared memory is the same at every D:
//   55 KB in bf16, 102 KB in fp32.  Rows past N are zero-filled by the
//   copies (a source size of 0).  One barrier a step: after it the buffer
//   that the previous step read is refilled kStages - 1 steps ahead.
// - bf16: mma.sync m16n8k16 with fp32 accumulate; Q and K fragments by
//   ldmatrix, V's by ldmatrix.trans; P goes from S's accumulator to the
//   A fragments of P V in registers (the C and A layouts line up).
// - fp32: mma.sync m16n8k8 in tf32, three products a product (lo.hi, hi.lo,
//   hi.hi, the small terms first; hi = rna(x), lo = rna(x - hi)), the
//   operands split in registers as they are read.  P V reads the keys of
//   each 8-key step permuted (logical k = c is key 2c, k = c + 4 is key
//   2c + 1), so S's accumulator columns (2c, 2c + 1) are P's A fragment
//   with no shuffle; V's rows are read in the same order.
// - Left for later: wgmma, a producer warp and TMA (as at D = 64 and 192),
//   a resident Q where it fits, and a split that does not recompute S.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;    // query rows a CTA: four warps of 16
constexpr int kKeys = 64;    // keys a tile
constexpr int kPanel = 64;   // columns a panel
constexpr int kSlice = 3;    // panels of O a CTA keeps: 192 columns
constexpr int kStages = 3;   // buffers of the cp.async ring
constexpr int kThreads = 128;

// The ring's layout: LD, the shared row stride in elements (64 plus 16
// bytes, so that the 8 rows an ldmatrix (bf16) or a fragment load (fp32)
// touches fall on distinct banks); TE, the elements of a 64 x 64 tile;
// SMEM, the ring's bytes.
template <typename E>
struct Lay {
  static constexpr int LD = kPanel + 16 / static_cast<int>(sizeof(E));
  static constexpr int TE = kKeys * LD;
  static constexpr int SMEM = kStages * 2 * TE * static_cast<int>(sizeof(E));
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n, heads, panels, slices, bh;
  long long qs[3], ks[3], vs[3], os[3];  // (b, n, h) element strides
  float scale_log2;                      // D^-0.5 * log2(e)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 64 x 64 tile into shared memory: rows r0 .. r0 + 63 of the (b, h)
// rows at `base` (row stride sn elements), columns c0 .. c0 + 63; rows at
// or past n read as zeros.
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* base, long long sn, int r0, int n,
                                          int c0) {
  constexpr int W = 16 / static_cast<int>(sizeof(E));  // elements a copy
  constexpr int PER_ROW = kPanel / W;
#pragma unroll
  for (int j = 0; j < kKeys * PER_ROW / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / PER_ROW, c = (i % PER_ROW) * W;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * Lay<E>::LD + c, base + (valid ? (r0 + r) * sn : 0) + c0 + c, valid);
  }
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: a (4 A-fragment floats) and b (2 B-fragment floats)
// already split into hi and lo
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

template <int N>
__device__ __forceinline__ void split_n(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float h, l;
    split_tf32(x[i], h, l);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(l);
  }
}

// S (this warp's 16 query rows x 64 keys, 8 n-tiles of the C layout in
// sc[4 t .. 4 t + 3]) += Q panel (`sq`: the warp's rows) . K panel^T.
__device__ __forceinline__ void qk_panel(float (&sc)[32], const bf16* sq, const bf16* sk,
                                         int lane) {
  constexpr int LD = Lay<bf16>::LD;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kPanel / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a[0], a[1], a[2], a[3], sq + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {  // n-tiles 2 nt and 2 nt + 1
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, sk + (nt * 16 + (mi >> 1) * 8 + rr) * LD + kk * 16 + (mi & 1) * 8);
      mma_bf16_16816(sc + 8 * nt, a, b0, b1);
      mma_bf16_16816(sc + 8 * nt + 4, a, b2, b3);
    }
  }
}

__device__ __forceinline__ void qk_panel(float (&sc)[32], const float* sq, const float* sk,
                                         int lane) {
  constexpr int LD = Lay<float>::LD;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kPanel / 8; ++kk) {
    const float* q = sq + kk * 8 + c;
    const float a[4] = {q[g * LD], q[(g + 8) * LD], q[g * LD + 4], q[(g + 8) * LD + 4]};
    uint32_t ah[4], al[4];
    split_n(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* kr = sk + (nt * 8 + g) * LD + kk * 8 + c;
      const float b[2] = {kr[0], kr[4]};
      uint32_t bh[2], bl[2];
      split_n(b, bh, bl);
      mma_3xtf32(sc + 4 * nt, ah, al, bh, bl);
    }
  }
}

// P as the P V product's A operand: in bf16 pairs packed from the fp32 p
// (16 keys a step); in fp32 nothing (P V reads p from S's registers and
// splits it at use).
template <typename E>
struct PFrag;
template <>
struct PFrag<bf16> {
  uint32_t a[4][4];
  __device__ __forceinline__ void set(const float (&p)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
  }
};
template <>
struct PFrag<float> {
  __device__ __forceinline__ void set(const float (&)[32]) {}
};

// acc (16 rows x 64 columns of one O panel) += P (16 x 64 keys) . V panel
// (`sv`: 64 keys x 64 columns); P from `pf` (bf16) or from p, S's
// registers (fp32).
__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<bf16>& pf,
                                         const float (&)[32], const bf16* sv, int lane) {
  constexpr int LD = Lay<bf16>::LD;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {  // column n-tiles 2 nt and 2 nt + 1
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        sv + (kk * 16 + (mi & 1) * 8 + rr) * LD + nt * 16 + (mi >> 1) * 8);
      mma_bf16_16816(acc + 8 * nt, pf.a[kk], b0, b1);
      mma_bf16_16816(acc + 8 * nt + 4, pf.a[kk], b2, b3);
    }
}

__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<float>&,
                                         const float (&p)[32], const float* sv, int lane) {
  constexpr int LD = Lay<float>::LD;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKeys / 8; ++kk) {
    // keys permuted: logical k = c is key 8 kk + 2c, k = c + 4 key 8 kk + 2c + 1
    const float a[4] = {p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3]};
    uint32_t ah[4], al[4];
    split_n(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* vr = sv + (kk * 8 + 2 * c) * LD + nt * 8 + g;
      const float b[2] = {vr[0], vr[LD]};
      uint32_t bh[2], bl[2];
      split_n(b, bh, bl);
      mma_3xtf32(acc + 4 * nt, ah, al, bh, bl);
    }
  }
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <typename E, bool FAST>
__global__ void __launch_bounds__(kThreads, 2) flash_wide(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ring = reinterpret_cast<E*>(smem_raw);
  constexpr int LD = Lay<E>::LD, TE = Lay<E>::TE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c2 = (lane & 3) * 2;
  const int bh = blockIdx.y + blockIdx.z * gridDim.y;
  if (bh >= p.bh) return;
  const int b = bh / p.heads, h = bh % p.heads;
  const int slice = blockIdx.x % p.slices, q0 = (blockIdx.x / p.slices) * kRows;
  const int first = slice * kSlice, ns = min(kSlice, p.panels - first);
  const int per = p.panels + ns;  // steps a key tile
  const int steps = (p.n + kKeys - 1) / kKeys * per;
  const E* qb = static_cast<const E*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const E* kb = static_cast<const E*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const E* vb = static_cast<const E*>(p.v) + b * p.vs[0] + h * p.vs[2];

  // step s: a Q panel and a K panel (slot 0, slot 1) or a V panel (slot 0)
  auto load_step = [&](int s) {
    const int j = s / per, r = s - j * per;
    E* buf = ring + (s % kStages) * 2 * TE;
    if (r < p.panels) {
      load_tile(buf, qb, p.qs[1], q0, p.n, r * kPanel);
      load_tile(buf + TE, kb, p.ks[1], j * kKeys, p.n, r * kPanel);
    } else {
      load_tile(buf, vb, p.vs[1], j * kKeys, p.n, (first + r - p.panels) * kPanel);
    }
  };

  float m_i[2] = {FAST ? 0.f : -INFINITY, FAST ? 0.f : -INFINITY};
  float l_i[2] = {0.f, 0.f};
  float acc[kSlice][32];
#pragma unroll
  for (int t = 0; t < kSlice; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  float sc[32];
  PFrag<E> pf;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1's buffer
    if (s + kStages - 1 < steps) load_step(s + kStages - 1);
    cp_async_commit();
    const E* buf = ring + (s % kStages) * 2 * TE;
    const int j = s / per, r = s - j * per;
    if (r < p.panels) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      }
      qk_panel(sc, buf + warp * 16 * LD, buf + TE, lane);
      if (r == p.panels - 1) {
        // the online softmax on the raw scores; scale * log2(e) folds into
        // the exp2's FMA.  Pad keys of the ragged last tile score -inf.
        const int valid = p.n - j * kKeys;
        if (valid < kKeys) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if ((i >> 2) * 8 + c2 + (i & 1) >= valid) sc[i] = -INFINITY;
        }
        if constexpr (!FAST) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
            const float m_new = fmaxf(m_i[rr], mx[rr] * p.scale_log2);
            const float alpha = exp2_approx(m_i[rr] - m_new);
            m_i[rr] = m_new;
            l_i[rr] *= alpha;
#pragma unroll
            for (int t = 0; t < kSlice; ++t)
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                acc[t][4 * e + 2 * rr] *= alpha;
                acc[t][4 * e + 2 * rr + 1] *= alpha;
              }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = exp2_approx(fmaf(sc[i], p.scale_log2, -m_i[(i >> 1) & 1]));
          l_i[(i >> 1) & 1] += sc[i];
        }
        pf.set(sc);
      }
    } else {
      const int t = r - p.panels;
#pragma unroll
      for (int pp = 0; pp < kSlice; ++pp)
        if (pp == t) pv_panel(acc[pp], pf, sc, buf, lane);
    }
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_i[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rr] = 1.f / l;
  }
  const int r0 = q0 + warp * 16 + (lane >> 2);
  E* ob = static_cast<E*>(p.o) + b * p.os[0] + h * p.os[2];
#pragma unroll
  for (int pp = 0; pp < kSlice; ++pp) {
    if (pp >= ns) break;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = (first + pp) * kPanel + t * 8 + c2;
      if (r0 < p.n)
        store2(ob + r0 * p.os[1] + col, acc[pp][4 * t] * inv[0], acc[pp][4 * t + 1] * inv[0]);
      if (r0 + 8 < p.n)
        store2(ob + (r0 + 8) * p.os[1] + col, acc[pp][4 * t + 2] * inv[1],
               acc[pp][4 * t + 3] * inv[1]);
    }
  }
}

template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
        int head_dim, const long long* st, float scale, int fast, void* stream) {
  if (batch < 0 || n < 0 || heads < 0 || head_dim <= 0 || head_dim % kPanel)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies: aligned bases and row strides
  constexpr long long W = 16 / sizeof(E);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (st[i] % W) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)batch * n * heads == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.n = n;
  p.heads = heads;
  p.panels = head_dim / kPanel;
  p.slices = (p.panels + kSlice - 1) / kSlice;
  p.bh = batch * heads;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = st[i];
    p.ks[i] = st[3 + i];
    p.vs[i] = st[6 + i];
    p.os[i] = st[9 + i];
  }
  p.scale_log2 = scale * 1.4426950408889634f;
  const long long gx = (long long)((n + kRows - 1) / kRows) * p.slices;
  if (gx > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int gy = p.bh < 65535 ? p.bh : 65535;
  const dim3 grid(static_cast<unsigned>(gx), gy, (p.bh + gy - 1) / gy);
  auto kern = fast ? flash_wide<E, true> : flash_wide<E, false>;
  constexpr int smem = Lay<E>::SMEM;
  const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, N, H, D) views with unit stride in D and the given (b, n,
// h) element strides (16-byte aligned bases, strides multiples of 16
// bytes); o likewise (4-byte aligned pairs).  D any multiple of 64 (the
// wrapper sends D >= 320 here).  fast != 0 selects the no-max variant.
// Returns cudaErrorInvalidValue for what the copies cannot read.
extern "C" int vda_flash_attention_wide(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, void* stream) {
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  return run<bf16>(q, k, v, o, batch, n, heads, head_dim, st, scale, fast, stream);
}

extern "C" int vda_flash_attention_wide_f32(
    const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
    int head_dim, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale, int fast, void* stream) {
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  return run<float>(q, k, v, o, batch, n, heads, head_dim, st, scale, fast, stream);
}
