// K1p in embed mode (GenCast's grid2mesh): fused_edge_pipelined.cu built as
// its own translation unit for gc_fused_edge_embed_pipelined, so that nvcc
// compiles K1p's kernels in parallel.

#define GC_K1P_UNIT 2
#include "fused_edge_pipelined.cu"
