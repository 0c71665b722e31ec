// The 32-rows-per-tile build of packed_glm.cu (same C interface), for the
// rows-per-tile comparison of dev/torch_kernel_probe.py.
#define PACKED_GLM_ROWS 32
#include "packed_glm.cu"
