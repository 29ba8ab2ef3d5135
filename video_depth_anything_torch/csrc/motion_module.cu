// Kernel C's launch: the Hopper kernel of motion_module.cuh at the widths
// the gate sends here.
#include "motion_module.cuh"

// vits (m0: 192; m1-m3 at the gate's sizes: 64), vitb (m2/m3: 128; m0 on
// 16:9 frames: 384) and vitl's m2/m3 (256); the rows per CTA and shared
// memory of each width are in motion_module.cuh.  8 <= T <= 32: a location
// takes T padded up to 8, 16 or 32 rows.
extern "C" int vda_motion_module(VDA_MM_ARGS) {
  const mm::Params p = VDA_MM_PARAMS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return mm::launch<64>(p, st);
    case 128: return mm::launch<128>(p, st);
    case 192: return mm::launch<192>(p, st);
    case 256: return mm::launch<256>(p, st);
    case 384: return mm::launch<384>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
