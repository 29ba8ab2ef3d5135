// Hopper (sm_90a) primitives of the port's Hopper kernels: mbarrier,
// TMA tensor and bulk loads, wgmma (bf16 and tf32) with its fences and
// shared-memory descriptors (128-byte swizzle, and no swizzle), the TF32
// round, setmaxnreg, named barriers, and the host-side tensor-map encoder
// (bf16 and fp32 elements).  Included by every kernel source.
//
// Layouts.  A TMA box of R rows x 64 bf16 (128 B per row) lands in shared
// memory as R rows of 128 B, each row's eight 16-byte chunks XOR-swizzled
// by (row % 8): CU_TENSOR_MAP_SWIZZLE_128B, matched by the descriptors'
// 128-byte swizzle mode.  Tiles start on 1024-byte boundaries (the swizzle
// atom is 8 rows x 128 B).  In fp32 a 128-byte row is 32 floats, and a
// tf32 k8 step is 32 bytes, as a bf16 k16 step: the same descriptors and
// the same 32-byte step along K (descriptor + 2 * k) serve both.
//   * K-major operand (rows = M or N, contiguous = the product's K axis):
//     SBO = 1024 B between 8-row groups; the k-th 16-wide step starts
//     32 * k bytes into the tile (descriptor + 2 * k).
//   * MN-major operand (rows = the product's K axis, contiguous = N, the
//     transposed B of P.V-type products, N = 64 = one swizzle atom wide):
//     SBO = 1024 B between 8-row groups of K; the k-th 16-row step starts
//     2048 * k bytes into the tile (descriptor + 128 * k).
// The wgmma accumulator of m64nN gives warp w of the warpgroup rows
// 16w..16w+15 in the mma.m16n8k16 C layout, n8 block after n8 block:
// d[4t + 0..1] = (row g, cols 8t + 2c..), d[4t + 2..3] = (row g + 8, same),
// g = lane >> 2, c = lane & 3 (common.cuh); the register A operand takes
// the m16n8k16 A fragment, so an accumulator converts to A in registers.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A struct of tiles placed at the first 1024-byte boundary of dynamic
// shared memory (the launch requests sizeof(T) + 1024 bytes).
template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

// ---- mbarrier ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init, before the barriers are used (then __syncthreads)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Wait for the completion of the barrier's phase of this parity (the k-th
// completion has parity k & 1).  A wait that outlasts 2^34 SM cycles
// (about 10 s) traps, so a deadlock surfaces as a launch error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// ---- TMA ----
// A box of the 4-D map at coordinates (c0 innermost .. c3), completed on
// `bar` (which counts the box's full bytes, zero-filled rows included).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A box of the 3-D map at coordinates (c0 innermost, c1, c2), completed on
// `bar` (which counts the box's full bytes, zero-filled elements included).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----
// A K-major operand with no swizzle: 8-row core matrices of 16-byte rows
// (rows 16 B apart, 128 contiguous bytes), the next core matrix along K
// `lbo` bytes on and along M or N `sbo` bytes on; the start needs only
// 16-byte alignment.
__device__ __forceinline__ uint64_t desc_noswizzle(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFFu) >> 4)  // start address
         | (static_cast<uint64_t>(1) << 16)                     // LBO (unused here)
         | (static_cast<uint64_t>(1024 >> 4) << 32)              // SBO: 8 rows of 128 B
         | (static_cast<uint64_t>(1) << 62);                     // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma.wait_group (the asm statements stay in order).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B^T, B[128 x 16]: both K-major in shared memory
// (descriptors); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B^T, B[64 x 16]: both K-major in shared memory
// (descriptors); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B, B[16 x 64]: A from registers (the m16n8k16 A
// fragment per warp, warp w of the warpgroup holding rows 16w..16w+15), B
// MN-major in shared memory (its contiguous axis is N: transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] B^T: A from registers (the m16n8k16 A fragment
// of each warp's 16 rows), B[32 x 16] K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- tf32 ----
// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as an fp32 value with its 13 low bits zero.  The tensor cores read only
// the top 19 bits of an fp32 operand (a truncation), so every tf32
// operand of the port is rounded by this first.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The 3xTF32 split: hi = rna(x), lo = rna(x - hi) (x - hi is exact), so
// hi + lo is x within 2^-22 of |x|.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// D[64 x 64] (+)= A[64 x 8] B^T in tf32: A from registers (each warp's 16
// rows in the mma.m16n8k8 tf32 A fragment: a0 = (g, c), a1 = (g + 8, c),
// a2 = (g, c + 4), a3 = (g + 8, c + 4), g = lane >> 2, c = lane & 3), B[64
// x 8] K-major in shared memory (tf32 takes no transposed operand);
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] B^T in tf32, A[64 x 8] and B[64 x 8] both
// K-major in shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] B^T in tf32, A[64 x 8] and B[32 x 8] both
// K-major in shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Generic-proxy shared-memory writes made visible to later wgmma reads
// (each writing thread, before the barrier that hands the data over).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers (0 is __syncthreads); n threads, a multiple of 32 ----
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The hardware exp2 (MUFU.EX2; flushes denormal results to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- register budget of warp-specialised CTAs ----
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps ----
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime; it is
// reached through the runtime's cudaGetDriverEntryPoint, so the libraries
// link no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The 4-D map (D, H, N, B) of a (B, N, H, D) view of bf16 (or, with `type`
// CU_TENSOR_MAP_DATA_TYPE_FLOAT32, fp32) elements with these element
// strides (16-byte aligned rows), D = `width` (64 unless given; a multiple
// of one 128-byte panel: 64 bf16 or 32 floats), boxes of (one panel, 1,
// rows, 1) with the 128-byte swizzle: a box at c0 = 64 p (bf16) or 32 p
// (fp32) is the p-th panel of the rows; rows past N read as zeros.
// False where the encoder refuses the map.  The encoder needs a current
// context, which a thread whose first CUDA work is this launch (autograd's
// backward thread) lacks: callers make a runtime call first, which binds
// the device's primary context to the thread.
inline bool make_map(CUtensorMap* map, const void* base, int batch, int n, int heads,
                     long long sb, long long sn, long long sh, int rows, int width = 64,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * elem,
                                 static_cast<cuuint64_t>(sn) * elem,
                                 static_cast<cuuint64_t>(sb) * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3-D map (R, T, B) of fp32 rows: B blocks of T rows of R contiguous
// floats (R a multiple of 4), boxes of (box_r, box_t, 1) with no swizzle: a
// box lands in shared memory as box_t rows of box_r floats, packed (a
// 128-byte aligned destination); coordinates past R, T or B read as zeros.
// False where the encoder refuses the map (callers make a runtime call
// first, as for make_map).
inline bool make_map_rows_f32(CUtensorMap* map, const void* base, long long r, int t, int b,
                              int box_r, int box_t) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(r), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(r) * 4,
                                 static_cast<cuuint64_t>(r) * t * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_r), static_cast<cuuint32_t>(box_t), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
