// The bf16 paged kernel's other launch plans, a library of their own.
//
// ragged_paged_attention.cu compiled with RPA_TILES 1: the same kernels and
// launch interface, instantiated for every plan of the bf16 per-warp kernel
// but the default one (block_q 16 or 32, 2 to 4 stages, as shared memory
// and the registers allow), and nothing else (no fp32 kernel, no latent
// kernel). Kept out of the default library so that its build does not
// grow; ops.py loads this one at the first launch that asks for such a plan
// (tune.py's candidates, or an override).

#define RPA_TILES 1
#include "ragged_paged_attention.cu"
