// Kernel C's split by stage at C = 384 (motion_module_split.cuh).
#include "motion_module_split.cuh"

VDA_MM_SPLIT(384)
