// K1 in embed mode (GenCast's grid2mesh): fused_edge.cu built as its own
// translation unit for gc_fused_edge_embed, so that nvcc compiles K1's
// kernels in parallel.

#define GC_K1_UNIT 2
#include "fused_edge.cu"
