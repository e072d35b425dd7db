// K5's edge pass in plain mode (the edge slots' backward and dgrid):
// fused_decoder_bwd.cu built as its own translation unit for
// gc_fused_decoder_bwd_edges, so that nvcc compiles K5's kernels in
// parallel.

#define GC_K5_UNIT 1
#include "fused_decoder_bwd.cu"
