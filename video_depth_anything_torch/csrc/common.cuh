// Shared device helpers of the port's kernels: bf16 packing, ldmatrix and
// the m16n8k16 bf16 tensor-core product (fp32 accumulate); the V-wide float
// loads and stores (Vec) and the reduce-scatter round over a query row's
// lanes (scatter_round) of Kernel B's FFMA kernels.
//
// Fragment layouts of mma.m16n8k16 (g = lane >> 2, c = lane & 3):
//   A (16x16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 8+2c..),
//                          a3 = (g+8, 8+2c..)
//   B (16x8, "col"):       b0 = (k 2c..2c+1, n g), b1 = (k 8+2c.., n g)
//   C (16x8 fp32):         c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const void* smem) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* smem) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V consecutive floats (V = 1, 2 or 4; V-float aligned) read and written
// as one access.
template <int V>
struct Vec;
template <>
struct Vec<1> {
  float x[1];
  __device__ __forceinline__ void load(const float* p) { x[0] = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = x[0]; }
};
template <>
struct Vec<2> {
  float x[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};
template <>
struct Vec<4> {
  float x[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

// Round R of a reduce-scatter over the lanes of a query row: keep the half
// of o[0, 2W) that bit R of c picks, send the other to lane ^ 2^R, and add
// what comes back (each round a loop of constant length, fully unrolled:
// o stays in registers).
template <int W, int R>
__device__ __forceinline__ void scatter_round(float* o, int c) {
  const bool upper = c >> R & 1;
#pragma unroll
  for (int y = 0; y < W; ++y) {
    const float keep = upper ? o[y + W] : o[y];
    const float send = upper ? o[y] : o[y + W];
    o[y] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << R);
  }
}
