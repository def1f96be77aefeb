// K1 / K1b on a rank's rows of an atom-sharded batch: fused_gnn.cu built
// with the sharded Drop (common.cuh), whose dropout masks are the unsharded
// masks' rows. Its C entry points are grappa_fused_gnn_fwd_rows and
// grappa_fused_gnn_bwd_rows, which also take the nodes' global count and
// the rank's first row; fused_gnn.cu's own entry points keep their code.
#define GRAPPA_SHARDED_DROP
#include "fused_gnn.cu"
