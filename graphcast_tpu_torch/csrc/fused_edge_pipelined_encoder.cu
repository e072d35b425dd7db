// K1p's two modes without We (encoder mode, and with e' written):
// fused_edge_pipelined.cu built as its own translation unit for
// gc_fused_edge_pipelined_nowe, so that nvcc compiles K1p's kernels in
// parallel.

#define GC_K1P_UNIT 1
#include "fused_edge_pipelined.cu"
