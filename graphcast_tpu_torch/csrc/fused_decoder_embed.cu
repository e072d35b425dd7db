// K2 in embed mode (GenCast's mesh2grid): fused_decoder.cu built as its own
// translation unit for gc_fused_decoder_embed, so that nvcc compiles K2's
// two kernels in parallel.

#define GC_K2_EMBED_UNIT
#include "fused_decoder.cu"
