// K5's node pass in embed mode (GenCast's mesh2grid backward):
// fused_decoder_bwd.cu built as its own translation unit for
// gc_fused_decoder_bwd_embed_nodes, so that nvcc compiles K5's kernels in
// parallel.

#define GC_K5_UNIT 2
#include "fused_decoder_bwd.cu"
