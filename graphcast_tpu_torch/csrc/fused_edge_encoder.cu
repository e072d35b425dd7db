// K1's two modes without We (encoder mode, and with e' written):
// fused_edge.cu built as its own translation unit for gc_fused_edge_nowe,
// so that nvcc compiles K1's kernels in parallel.

#define GC_K1_UNIT 1
#include "fused_edge.cu"
