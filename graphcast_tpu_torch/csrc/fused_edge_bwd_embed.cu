// K4 in embed mode (GenCast's grid2mesh): fused_edge_bwd.cu built as its own
// translation unit for gc_fused_edge_bwd_embed, so that nvcc compiles K4's
// kernels in parallel.

#define GC_K4_UNIT 2
#include "fused_edge_bwd.cu"
