// Kernel C's split by stage (motion_module.cuh's STOP): built apart from the
// launch, one width a source (motion_module_split{64,128,256,384}.cu), so
// that its 32 instantiations compile in four processes in parallel with the
// rest (in one, they took 60 s of a 72 s build on the card's 8-core host).
#pragma once

#include "motion_module.cuh"

namespace mm_split {

// ms[k] (k = 0..7): mean ms of `iters` launches of the kernel stopped after
// stage k (7: the whole kernel), CUDA events around each batch.
template <int C>
int split(const mm::Params& p, cudaStream_t st, int iters, float* ms) {
  typedef int (*Fn)(const mm::Params&, cudaStream_t);
  const Fn fns[8] = {mm::launch<C, 0>, mm::launch<C, 1>, mm::launch<C, 2>, mm::launch<C, 3>,
                     mm::launch<C, 4>, mm::launch<C, 5>, mm::launch<C, 6>, mm::launch<C, 7>};
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int err = 0;
  for (int k = 0; k < 8 && err == 0; ++k) {
    err = fns[k](p, st);
    cudaEventRecord(e0, st);
    for (int i = 0; i < iters && err == 0; ++i) err = fns[k](p, st);
    cudaEventRecord(e1, st);
    if (err == 0) err = static_cast<int>(cudaEventSynchronize(e1));
    if (err == 0) err = static_cast<int>(cudaEventElapsedTime(&ms[k], e0, e1));
    ms[k] /= iters;
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return err;
}

}  // namespace mm_split

// vda_motion_module_split_<W>: the split at width W (one of the widths
// chip_smoke.py reports it for); synchronises the stream.  Another C
// returns cudaErrorInvalidValue.
#define VDA_MM_SPLIT(W)                                                               \
  extern "C" int vda_motion_module_split_##W(VDA_MM_ARGS, int iters, float* ms) {    \
    if (C != W) return static_cast<int>(cudaErrorInvalidValue);                      \
    const mm::Params p = VDA_MM_PARAMS;                                               \
    return mm_split::split<W>(p, static_cast<cudaStream_t>(stream), iters, ms);      \
  }
