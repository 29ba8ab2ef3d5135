// Kernel B: temporal attention core of the motion modules, for Hopper.
//
// Replaces video_depth_anything_tpu/ops/pallas_temporal.py:_temporal_kernel
// (via temporal_attention_window).  For every (batch, location, head) of
// (B, T, S, C) bf16 tensors it attends over the frame axis: fp32 scores
// q_t . k_t' over the head dim d = C / heads, an fp32 softmax over the
// T <= 32 key frames, probabilities rounded to bf16, sum_t' p . v_t'
// accumulated in fp32, bf16 out -- the numerics of the JAX einsum path.
// d in {8, 16, 24, 32, 48, 128}: every head width the JAX gate admits on
// the shipped encoders (vits, vitb, vitl).
//
// Bound on the H100: bytes.  4 * B * S * C * T^2 FLOPs against 8 * B * T *
// S * C bytes (q, k, v read once, out written once) is T / 2 = 16 FLOPs a
// byte, far below the ~295 of the bf16 ridge, so the least time is the
// bytes over 3.35 TB/s.  The earlier design (one CTA per location, load ->
// compute -> store with nothing in flight during compute, one query frame
// per lane on CUDA cores) ran 5-6x above that.
//
// Design.
// - A persistent, pipelined walk.  Resident CTAs walk tiles of
//   (L adjacent locations x G whole heads) over all T frames.  A producer
//   warp fills a ring of shared-memory stages with bulk copies
//   (cp.async.bulk, completion on an mbarrier with the tile's byte count),
//   one copy per (tensor, frame) run -- L * C * 2 contiguous bytes when a
//   tile holds every head (C <= 256: L = 256 / C locations, runs of 512 B
//   at C = 64, 128 and 256, 384 B at 192), else one per (tensor, frame,
//   location) of G * d channels (C = 384: 4 heads of 48; C = 1024: 2 of
//   128).  Two stages a CTA (<= 102 KB), so two CTAs share an SM: the
//   next tile's q, k and v are in flight while the current one computes,
//   and the other CTA's hand-offs overlap this one's.  The tile geometry
//   comes from the wrapper (ops/temporal_attention.tile_plan).
// - Shared rows of L * G * d + 8 bf16, one per frame: an odd number of
//   16-byte chunks, so the ldmatrix reads of 8 frames hit 8 different
//   bank groups (no swizzle needed, and the bulk copies land whole runs).
// - Products on the tensor cores with mma.sync.  A consumer warp owns a
//   (location, head, query rows) unit: all 32 query frames for d <= 32
//   (32 x 32 scores, 32 x d outputs), 16 of them for d = 48 and 128 (two
//   units per head: 16 x 128 outputs are 64 accumulator floats a lane).
//   S = Q K^T in m16n8k16 steps, the last 8 of d = 8, 24 and 48 in one
//   m16n8k8 step; the row softmax reduces across the four lanes that hold
//   an accumulator row; the score fragment becomes P.V's A fragment with
//   no shuffle.  Keys at or past T score -inf (the ring's rows past T are
//   never loaded, and a zero row would score 0, not -inf); v's rows there
//   are zeroed once, so that their probability 0 meets finite values.
// - Output: each warp writes its unit's rows over its own q rows in
//   shared memory; after a barrier of the consumers the tile goes out with
//   coalesced 16-byte stores (rows past T and locations past S skipped),
//   and the stage is handed back to the producer.
// - Why not wgmma: it takes 64 rows, against 32 query frames per
//   (location, head); stacking two locations would spend half of every
//   product on off-diagonal blocks, and the products are not what bounds
//   this kernel.
// STOP = true keeps the copies in and out and drops the attention (the
// output is q): the kernel's split, timed by bench_temporal.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 32;           // frame rows per tile (T <= 32)
constexpr int kMaxWarps = 8;     // consumer warps
constexpr int kStages = 2;       // ring depth
constexpr int kBarBytes = 2 * kStages * 8;
constexpr int kSmemMax = 227 * 1024;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, T, S, C;
  int L, G;          // locations and heads per tile
  int ld;            // shared row stride, elements: L * G * d + 8
  int nw;            // consumer warps
  int sblocks, hgroups, tiles;
  float scale_log2;  // d^-0.5 * log2(e)
};

__host__ __device__ constexpr int query_tiles(int d) { return d >= 48 ? 1 : 2; }  // m16 tiles a unit
__host__ __device__ constexpr int row_slabs(int d) { return 2 / query_tiles(d); }  // units a head

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x8, a0 = (g, 2c..), a1 = (g + 8, 2c..)) b (8x8, b = (k 2c.., n g))
__device__ __forceinline__ void mma_bf16_1688(float* c, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void decode(const Params& p, int tile, int cg, int& b, int& s0, int& c0,
                                       int& lv) {
  const int hg = tile % p.hgroups, r = tile / p.hgroups;
  const int sb = r % p.sblocks;
  b = r / p.sblocks;
  s0 = sb * p.L;
  c0 = hg * cg;
  lv = min(p.L, p.S - s0);
}

// One unit: query rows row0 .. row0 + 16 * MT - 1 of the head whose
// columns start at `col`, in the stage at `base` (q, k, v: kT rows of ld
// each).  The output overwrites this unit's own q rows and columns.
template <int D>
__device__ __forceinline__ void attend(bf16* base, int ld, int col, int row0, int T, float sl2,
                                       int lane) {
  constexpr int MT = query_tiles(D);
  constexpr int KS = D / 16;         // full k16 steps of S
  constexpr bool K8 = D % 16 != 0;   // and a last k8 step
  constexpr int DN = D / 8;          // n8 tiles of O
  bf16* sq = base;
  const bf16* sk = base + kT * ld;
  const bf16* sv = base + 2 * kT * ld;
  const int g = lane >> 2, c4 = lane & 3, j = lane >> 3, r8 = lane & 7, r16 = lane & 15;

  float s[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = col + ks * 16;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                  sq + (row0 + mt * 16 + r16) * ld + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {  // key tiles 2np, 2np + 1
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, sk + (np * 16 + (j >> 1) * 8 + r8) * ld + k0 + (j & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(s[mt][2 * np], a[mt], b0, b1);
        mma_bf16_16816(s[mt][2 * np + 1], a[mt], b2, b3);
      }
    }
  }
  if constexpr (K8) {
    const int k0 = col + KS * 16;
    uint32_t b[4];
    ldmatrix_x4(b[0], b[1], b[2], b[3], sk + (j * 8 + r8) * ld + k0);  // key tile j
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a0, a1;
      ldsm_x2(a0, a1, sq + (row0 + mt * 16 + r16) * ld + k0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16_1688(s[mt][nt], a0, a1, b[nt]);
    }
  }

  // softmax over the key frames: row g in e = 0, 1, row g + 8 in e = 2, 3;
  // key nt * 8 + 2 * c4 + (e & 1), masked at or past T
  uint32_t pa[MT][2][4];  // P as A fragments: [m tile][k16 step over keys]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + 2 * c4 + (e & 1);
        const float x = key < T ? s[mt][nt][e] * sl2 : -INFINITY;
        s[mt][nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][nt][e] = exp2_approx(s[mt][nt][e] - mx[e >> 1]);
        sum[e >> 1] += s[mt][nt][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      sum[h] = __fdividef(1.f, sum[h]);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[mt][kk][0] = pack_bf16x2(s[mt][2 * kk][0] * sum[0], s[mt][2 * kk][1] * sum[0]);
      pa[mt][kk][1] = pack_bf16x2(s[mt][2 * kk][2] * sum[1], s[mt][2 * kk][3] * sum[1]);
      pa[mt][kk][2] = pack_bf16x2(s[mt][2 * kk + 1][0] * sum[0], s[mt][2 * kk + 1][1] * sum[0]);
      pa[mt][kk][3] = pack_bf16x2(s[mt][2 * kk + 1][2] * sum[1], s[mt][2 * kk + 1][3] * sum[1]);
    }
  }

  float o[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk == 1 && T <= 16) break;  // P is 0 past T and v's rows there zero
#pragma unroll
    for (int dp = 0; dp < DN / 2; ++dp) {  // column tiles 2dp, 2dp + 1
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        sv + (kk * 16 + (j & 1) * 8 + r8) * ld + col + (2 * dp + (j >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(o[mt][2 * dp], pa[mt][kk], b0, b1);
        mma_bf16_16816(o[mt][2 * dp + 1], pa[mt][kk], b2, b3);
      }
    }
    if constexpr (DN % 2 == 1) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, sv + (kk * 16 + r16) * ld + col + (DN - 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(o[mt][DN - 1], pa[mt][kk], b0, b1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + g + 8 * h;
      if (r < T) {
#pragma unroll
        for (int dn = 0; dn < DN; ++dn)
          *reinterpret_cast<uint32_t*>(sq + r * ld + col + dn * 8 + 2 * c4) =
              pack_bf16x2(o[mt][dn][2 * h], o[mt][dn][2 * h + 1]);
      }
    }
}

template <int D, bool STOP>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 1) temporal_hopper(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + kBarBytes);
  const int stage_elems = 3 * kT * p.ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthr = p.nw * 32;  // consumer threads
  const int cg = p.G * D;

  // v's rows past T are never loaded: zero them once, so that the masked
  // keys (probability 0) meet finite v rows.  Rows past T of q and k, and
  // locations past S, feed only rows and units that are never stored.
  const int zrow = p.ld / 8, zrows = (kT - p.T) * zrow;
  for (int i = threadIdx.x; i < kStages * zrows; i += blockDim.x) {
    const int st = i / zrows, r = i - st * zrows;
    reinterpret_cast<uint4*>(ring + st * stage_elems + (2 * kT + p.T) * p.ld)[r] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nthr);
    }
    fence_mbar_init();
  }
  fence_async_smem();  // the zeros before any bulk copy's writes
  __syncthreads();

  if (warp == p.nw) {  // the producer warp
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
      const int st = it % kStages, n = it / kStages;
      if (n > 0) mbar_wait(&empty[st], (n - 1) & 1);
      int b, s0, c0, lv;
      decode(p, tile, cg, b, s0, c0, lv);
      const uint32_t row_bytes = cg * 2;
      if (lane == 0) mbar_arrive_expect_tx(&full[st], 3u * p.T * lv * row_bytes);
      __syncwarp();
      bf16* base = ring + st * stage_elems;
      if (cg == p.C) {  // every head: one run of lv whole locations per (tensor, frame)
        for (int i = lane; i < 3 * p.T; i += 32) {
          const int x = i / p.T, t = i - x * p.T;
          const bf16* src = x == 0 ? p.q : x == 1 ? p.k : p.v;
          bulk_load(base + (x * kT + t) * p.ld, src + ((long long)(b * p.T + t) * p.S + s0) * p.C,
                    lv * row_bytes, &full[st]);
        }
      } else {  // a head group: one run per (tensor, frame, location)
        for (int i = lane; i < 3 * p.T * lv; i += 32) {
          const int l = i % lv, r = i / lv, x = r / p.T, t = r - x * p.T;
          const bf16* src = x == 0 ? p.q : x == 1 ? p.k : p.v;
          bulk_load(base + (x * kT + t) * p.ld + l * cg,
                    src + ((long long)(b * p.T + t) * p.S + s0 + l) * p.C + c0, row_bytes,
                    &full[st]);
        }
      }
    }
    return;
  }

  constexpr int RS = row_slabs(D);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    int b, s0, c0, lv;
    decode(p, tile, cg, b, s0, c0, lv);
    bf16* base = ring + st * stage_elems;
    if (!STOP) {
      const int units = p.L * p.G * RS;  // location-major
      for (int u = warp; u < units; u += p.nw) {
        const int l = u / (p.G * RS);
        if (l >= lv) break;  // past S, as every later unit
        const int h = (u / RS) % p.G, row0 = (u % RS) * 16 * query_tiles(D);
        if (row0 < p.T) attend<D>(base, p.ld, l * cg + h * D, row0, p.T, p.scale_log2, lane);
      }
    }
    bar_sync(1, nthr);
    const int chunks = cg / 8, per_t = lv * chunks;
    for (int i = threadIdx.x; i < p.T * per_t; i += nthr) {
      const int t = i / per_t, r = i - t * per_t, l = r / chunks, cc = (r - l * chunks) * 8;
      *reinterpret_cast<uint4*>(p.o + ((long long)(b * p.T + t) * p.S + s0 + l) * p.C + c0 + cc) =
          *reinterpret_cast<const uint4*>(base + t * p.ld + l * cg + cc);
    }
    fence_async_smem();  // this stage's generic writes before the next fill
    mbar_arrive(&empty[st]);
  }
}

template <int D, bool STOP>
int launch(Params p, cudaStream_t stream) {
  auto kern = temporal_hopper<D, STOP>;
  static bool configured = false;
  static int sms = 0;
  if (!configured) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    configured = true;
  }
  const int smem = kBarBytes + kStages * 3 * kT * p.ld * 2;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.nw = std::min(kMaxWarps, p.L * p.G * row_slabs(D));
  const int threads = 32 * (p.nw + 1);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  per_sm = std::max(1, per_sm);
  const int grid = std::min(p.tiles, per_sm * sms);
  kern<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const Params& p, int stop, cudaStream_t stream) {
  return stop ? launch<D, true>(p, stream) : launch<D, false>(p, stream);
}

}  // namespace

// q, k, v, o: contiguous (B, T, S, C) bf16, 16-byte aligned, C = heads * d,
// 1 <= T <= 32.  A tile holds `locs` adjacent locations x `group` whole
// heads (group divides heads): ops/temporal_attention.tile_plan.  stop = 1
// runs the split (copies only, out = q).  Returns cudaErrorInvalidValue for
// a d without an instantiation or a tile that does not fit.
extern "C" int vda_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int T, int S, int C, int heads, float scale,
                                      int locs, int group, int stop, void* stream) {
  if (heads <= 0 || C % heads || T < 1 || T > kT || locs < 1 || group < 1 || heads % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / heads;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.B = B;
  p.T = T;
  p.S = S;
  p.C = C;
  p.L = locs;
  p.G = group;
  p.ld = locs * group * d + 8;
  p.nw = 0;
  p.sblocks = (S + locs - 1) / locs;
  p.hgroups = heads / group;
  p.tiles = B * p.sblocks * p.hgroups;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return dispatch<8>(p, stop, st);
    case 16: return dispatch<16>(p, stop, st);
    case 24: return dispatch<24>(p, stop, st);
    case 32: return dispatch<32>(p, stop, st);
    case 48: return dispatch<48>(p, stop, st);
    case 128: return dispatch<128>(p, stop, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
