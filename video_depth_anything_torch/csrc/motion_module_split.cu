// Kernel C's split by stage (motion_module.cuh's STOP): built apart from the
// launch so that its 32 instantiations compile in parallel with the rest.
#include "motion_module.cuh"

namespace {

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

}  // namespace

// The split at the widths chip_smoke.py reports it for; synchronises the
// stream.  Other widths return cudaErrorInvalidValue.
extern "C" int vda_motion_module_split(VDA_MM_ARGS, int iters, float* ms) {
  const mm::Params p = VDA_MM_PARAMS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return split<64>(p, st, iters, ms);
    case 128: return split<128>(p, st, iters, ms);
    case 256: return split<256>(p, st, iters, ms);
    case 384: return split<384>(p, st, iters, ms);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
