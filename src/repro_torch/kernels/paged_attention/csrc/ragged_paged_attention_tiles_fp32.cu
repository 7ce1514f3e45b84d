// The fp32 paged kernel's other launch plans, a library of their own.
//
// ragged_paged_attention.cu compiled with RPA_TILES 2: every plan of the
// fp32 per-warp kernel but the default one (block_q 16 or 32, that is 4 or
// 8 rows, and 2 to 4 stages, as shared memory and the registers allow), and
// nothing else. ops.py loads it at the first fp32 launch that asks for such
// a plan; ragged_paged_attention_tiles.cu holds the bf16 ones.

#define RPA_TILES 2
#include "ragged_paged_attention.cu"
