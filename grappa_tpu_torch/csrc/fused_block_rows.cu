// K2 / K2b on a rank's tuples of an atom-sharded batch: fused_block.cu built
// with the sharded Drop (common.cuh), whose dropout masks are slices of the
// unsharded (S, T, F) masks along T. Its C entry points are
// grappa_fused_block_fwd_rows and grappa_fused_block_bwd_rows, which also
// take the tuples' global count and the rank's first tuple;
// fused_block.cu's own entry points keep their code.
#define GRAPPA_SHARDED_DROP
#include "fused_block.cu"
