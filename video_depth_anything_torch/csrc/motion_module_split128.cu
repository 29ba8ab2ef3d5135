// Kernel C's split by stage at C = 128 (motion_module_split.cuh).
#include "motion_module_split.cuh"

VDA_MM_SPLIT(128)
