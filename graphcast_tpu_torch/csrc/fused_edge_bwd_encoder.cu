// K4 in encoder mode: fused_edge_bwd.cu built as its own translation unit
// for gc_fused_edge_bwd_encoder, so that nvcc compiles K4's kernels in
// parallel.

#define GC_K4_UNIT 1
#include "fused_edge_bwd.cu"
