#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
Hopper card: the serving paths, dense attention (qwen3-8b), SSM
(mamba2-2.7b), hybrid (hymba-1.5b: attention and SSD heads in every
layer), MLA + MoE (deepseek-v2-lite-16b), MoE under a window
(mixtral-8x22b), multi-codebook audio (musicgen-large), a vision prefix
(internvl2-76b) and the ring-cache path beside the paged one
(gemma2-27b: alternating 4096/global windows; mamba2-2.7b, hymba-1.5b and
deepseek-v2-lite-16b), the fleet (two engine replicas behind the cluster
frontend, prefixes migrating between them under the lockstep and the
event clock) and fault injection into live pages, the training paths
(gemma-2b; mamba2-2.7b and hymba-1.5b through the SSD backward;
deepseek-v2-lite-16b's MLA + MoE through the flash kernels' Dk != Dv mode;
musicgen-large's codebooks), and their six kernels, ragged paged
attention in both its position modes (the latent head's too, reading one
plane or two).

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each printing one JSON line:

1. device      — requires CUDA; the card's name and power limit (nvidia-smi);
2. build       — builds the three kernel libraries (ragged paged
                 attention, SSD chunk scan, flash attention) from ``src/``
                 with one nvcc each, started together, into
                 ``build/repro_torch_kernels/``; prints ptxas's registers,
                 shared memory and spills per kernel and the HGMMA/HMMA
                 count of each (``cuobjdump -sass``), and requires HGMMA in
                 every instantiation of the bf16 flash forward, dK/dV and
                 dQ kernels (the (Dk 192, Dv 128) ones included: 30 in all)
                 and HMMA in the bf16 paged-attention (the latent-head
                 kernel included) and SSD kernels;
3. kernel      — holds ragged paged attention against its plain PyTorch
                 version at the qwen3-8b path's geometry (32/8 heads, D
                 128: decode / sparse table / extend / softcap / window, and
                 KV ranges of more splits than one CTA takes) and at
                 hymba-1.5b's (25/5 heads, a group of 5, D 64: decode over
                 kv 161-230, the 160-row first chunk over five pages, the
                 chunk after it, windows 64 and 2048), at deepseek-v2-lite's
                 latent head (16 query heads on one KV head of D 576) and
                 its reduced config's (4 on one of D 80: decode over the
                 serve traffic's lengths, a sparse table, a 32-row chunk
                 over three pages, a whole prompt, softcap + window, long
                 decodes, several slots a split), at mixtral-8x22b's (48/8
                 at D 128, a group of 6: decode over the serve lengths, a
                 64-row chunk, a sparse table, and with its window of 4096 a
                 decode and a 64-row chunk over kv 4160-4700), at
                 internvl2-76b's (64/8 at D 128, a group of 8: the 320-row
                 first chunk over ten pages, the 64-row chunk after it,
                 decode) and at musicgen-large's (MHA 32/32 at D 64, a group
                 of 1: decode, a 32-row chunk), fp32 and bf16; at the latent
                 head also 32 decodes of 4096, a 64-token chunk (1,024 rows)
                 at kv 4096 (and under a window of 1000), and pages of 8,
                 16, 24 and 64 tokens (decode, extend, long decode, a sparse
                 table under a window; 8 and 24 take the latent kernel's
                 hand copies instead of its TMA boxes);
                 checks bit-equality under trailing null table slots,
                 between a row's decode and extend launches, and between a
                 latent sequence decoded alone and as one of a batch of 32
                 (kv 96-4033), and times the kernel, its plain version and
                 one PyTorch library call (CUDA events, L2 flushed; the
                 kernel and the library call also by the profiler's device
                 time) at the main paths' decodes, extends and long decodes
                 (4 x 4096; at the latent head also 32 x 4096, the 64-token
                 chunk and pages of 16 and 64), naming the
                 ``scaled_dot_product_attention`` backend that takes D 576;
3b. ring kernel — ragged paged attention in its explicit-position mode
                 (the ring path's) at gemma2-27b's geometry (32/16 heads, D
                 128, softcap 50), fp32 and bf16, against its plain version:
                 a wrapped 4096-slot ring under the 4096 window with queries
                 up to 120 past its newest key, a 4800-slot ring with empty
                 slots, decodes of 4 sequences, 504-row extend chunks; and
                 with the slot-derived positions written out, bit-equal to
                 the slot-derived mode on the same pages; times the kernel,
                 the ring path's whole call on the fused ring, its plain
                 version and SDPA with the stored positions' mask;
3c. latent ring kernel — the same mode at deepseek-v2-lite-16b's latent
                 head (16/1 at D 576: the bf16 latent kernel, the fp32
                 kernel) and its reduced D 80, on 128-slot rings (empty
                 slots, wrapped, decodes of 4, 48-row extends) and (D 576)
                 on four wrapped 4096-slot rings (full, and 2% empty),
                 reading one
                 plane (V from K: the MLA ring) and two ([c, kr] / [c, 0]),
                 lanes [0, r) bit-equal between them, slot-derived
                 positions bit-equal to the slot mode in both layouts; and
                 at hymba-1.5b's 25/5 at D 64 on 256-slot rings under
                 windows 2048 and 64; fp32 and bf16, repeat launches
                 bit-equal; times the latent decode (128 and 4096 slots)
                 and extend (one plane and two) and hymba's decode against
                 their bounds, plain versions and SDPA with the positions'
                 mask;
4. ssd kernel  — holds the SSD chunk scan against its plain version (y and
                 final state) at the mamba2-2.7b path's geometry (H 80, P
                 64, N 128) for S 1/9/32, a multi-chunk S 512, a G > 1
                 batch, x/b/c as views into one projection, and at
                 hymba-1.5b's (H 50 in one group, P 64, N 16) for S 1 and
                 32 with a state, the 160-row first chunk from zeros and
                 the projection views; zero and random initial states, fp32
                 (FMA kernel) and bf16 (tensor-core kernel); checks that two
                 launches are bit-equal; times the kernel (events and the
                 profiler's device time) and its plain version (no single
                 PyTorch call computes an SSD scan);
4b. ssd bwd kernel — the SSD backward (fp32: states, backward and
                 reduce FMA kernels; bf16: states, gradients and d(a)
                 tensor-core kernels) against its plain version
                 ``ssd_scan_bwd_ref`` and against autograd through
                 ``ssd_scan_ref``, both on the card, at mamba2-2.7b's (H 80,
                 P 64, N 128) and hymba-1.5b's (H 50, P 64, N 16)
                 geometries: S 256 with an initial state and a final-state
                 cotangent, a ragged S 40 (B 2) without, and the training
                 shapes 4 x 2048 / 2 x 2176 with x/b/c as projection views;
                 and at P 16 / N 256 and P 128 / N 128 (B 2, S 100, a state:
                 the gradients kernel's other layouts); fp32 and bf16
                 (tolerances set from each
                 plain version's error against float64); two launches
                 bit-equal; times at the training shapes (device ms, the
                 states and gradients passes apart, the bound, the plain
                 version);
5. flash       — holds the flash-attention forward and both backward
                 kernels against their plain versions and against autograd
                 through the naive oracle, at the gemma-2b (B 4, S 2048, H 8,
                 Hkv 1, D 256) and qwen3-8b (H 32, Hkv 8, D 128) geometries,
                 with softcap 50 + window 64, at gemma2-27b's ring prefill
                 (S 4400, 32/16 heads at D 128, softcap 50, window 4096), at a
                 ragged S 1000, at D 64
                 and D 32, at S 17 (below a tile) and with G = 3, fp32 and
                 bf16 (bf16 through the tensor-core forward, dK/dV and dQ
                 kernels), at hymba-1.5b's ring first chunk (S 160,
                 25/5 at D 64, window 2048), at its training shape (B 2,
                 S 2176, the window binding), and at Dk 192 != Dv 128:
                 deepseek-v2-lite's un-absorbed MLA training shape (B 4, S
                 2048, 16/16 heads), a ragged S 1000, S 17, softcap 30 +
                 window 64, G = 3, and G = 3 at S 1500 (the bf16 dK/dV
                 kernel cuts key tiles); at musicgen-large's training shape
                 (B 4, S 2048, 32/32 heads at D 64); checks that repeat
                 launches are bit-equal, and the cut key tiles at (192, 128)
                 with 64-row units against the plain version; times the
                 three kernels (achieved TFLOP/s, share of the bound; dK/dV
                 also without its row split), their plain versions and
                 ``scaled_dot_product_attention`` (forward, forward +
                 backward) at the gemma-2b shape and at the three training
                 shapes (hymba, deepseek, musicgen: 5 rounds alternating
                 with the first SDPA backend that takes the inputs, named;
                 median and range; the SM clock before and after), and
                 records the bf16 kernels and plain versions against
                 float64 at the gemma-2b shape;
6. reduced     — the models' paged prefill / extend / decode on reduced fp32
                 qwen3-8b, mamba2-2.7b and hymba-1.5b (page 16), CUDA (the
                 kernels) against the CPU path (the plain versions), same
                 weights; and on CUDA a reduced mamba2 engine's and a
                 reduced hymba engine's (page 4: the first chunk spans three
                 pages) prefix hits decode the tokens of a cold start, in
                 fp32 and in bf16; the same for reduced deepseek-v2-lite-16b
                 (MLA on D 80 latent pages, MoE; engines at page and chunk
                 16); the same for reduced mixtral-8x22b (8 experts top-2,
                 window 64), musicgen-large (4 codebooks) and internvl2-76b
                 (8 patch embeddings, drawn by ``models/frontends.py``),
                 page and chunk 16, wq/wk conditioned for CUDA vs CPU; the
                 weights of reduced qwen3-8b, mamba2-2.7b, gemma-2b,
                 hymba-1.5b, deepseek-v2-lite-16b, mixtral-8x22b,
                 musicgen-large and internvl2-76b drawn on the card equal
                 the CPU's bit for bit; the ring path on a reduced fp32
                 gemma2-27b (prefill / extend that wraps the local rings /
                 decode, CUDA vs CPU), and a reduced qwen3-8b's ring and
                 paged engines decoding the same tokens on CUDA; the ring
                 path of reduced mamba2-2.7b, hymba-1.5b and
                 deepseek-v2-lite-16b (prefill / extend / decode, CUDA vs
                 CPU, logits and every ring leaf), and reduced hymba (page
                 4) and deepseek ring and paged engines decoding the same
                 tokens on CUDA;
6b. reduced fleet — two replicas of a reduced fp32 engine (page and chunk
                 16) behind ``ClusterFrontend`` with prefix migration forced
                 (``migrate_load_gap=-1``), on CUDA: deepseek-7b, mamba2-2.7b,
                 deepseek-v2-lite-16b and hymba-1.5b on the ring path
                 (positional, point, MLA and hybrid snapshots shipped as host
                 tensors) and qwen3-8b on the paged plane (pages shipped),
                 lockstep and event clocks: a migrated hit skipped prefill on
                 the receiver, the fan-out decodes a cold CUDA engine's
                 tokens, lockstep tokens equal event tokens, and the fleet
                 report sums its replicas' tokens and tier bytes;
6c. reliability — the three arms of ``benchmarks/serving_sim.py``'s
                 reliability gate (clean, protected with scrub-on-read,
                 over-aged without refresh) on reduced fp32 deepseek-7b, on
                 CUDA with the gate's thresholds, and each arm's injection
                 counters equal to the same arm on the CPU;
7. reduced train — reduced gemma-2b (head_dim 256) in fp32, same weights
                 (wq and wk conditioned, see ``conditioned``): three AdamW
                 steps on CUDA (the flash kernels) against the CPU (the
                 plain versions) within 1e-4, and on CUDA a save / restore
                 / resume that continues the loss; then reduced fp32
                 mixtral-8x22b (the MoE aux loss), musicgen-large (4
                 codebooks) and internvl2-76b (patch embeddings in
                 front), three AdamW steps CUDA against CPU within 1e-4;
8. full-width grads — gemma-2b at full width, 3 layers, fp32, 1 x 512
                 tokens: loss and every gradient leaf on CUDA (the kernels)
                 against the CPU (the plain versions) within 1e-4, with
                 conditioned wq/wk; for both initialisations it records the
                 plain versions against themselves on weights moved by half
                 an ulp, and attention alone at that initialisation's
                 scales, kernels and plain versions against float64;
8b. mla grads  — deepseek-v2-lite-16b at full width, 2 layers (the dense
                 layer and one MoE layer), fp32, 1 x 512 tokens: the loss
                 (ce, z_loss, aux), grad norm and every leaf through the
                 Dk 192 / Dv 128 flash kernels (CUDA) against the plain
                 versions (CPU) within 1e-5 / 1e-4 / 1e-4, wq and w_uk
                 conditioned;
8c. ssm grads  — mamba2-2.7b at full width, 2 layers, fp32, 1 x 512
                 tokens: loss and every gradient leaf through the SSD
                 forward and backward kernels (CUDA) against the plain
                 versions (CPU) within 1e-5 (loss) and 1e-4 (grad norm, each
                 leaf's largest |grad|), at the reference's initialisation;
9. serve       — qwen3-8b at full width and depth (36 layers, d 4096,
                 vocab 151936, bf16, random weights from a seed) through
                 ``ServeEngine`` with ``launch/serve.py``'s defaults, 8 requests
                 x 16 new tokens behind a shared 32-token head; every layer
                 of every model call launched the attention kernel;
9b. fleet serve — two qwen3-8b engines on the serve phase's weights (no
                 second draw) behind the launcher's cluster frontend with
                 ``--migrate-prefixes`` (gap forced to -1), the same traffic,
                 under the lockstep clock and the event clock: migrations,
                 ragged paged attention launched in both replicas (each
                 count read from zero), fleet decode tokens/s, wall, peak
                 memory, the idle share, migration bytes and time, the event
                 trace digest, and the share of event tokens equal to
                 lockstep tokens (recorded: bf16 ties); then one engine on
                 the same weights with ``--inject-rber 1e-3 --ecc-profile
                 domain``: pages visited, flips, wall beside the clean run;
10. ssm serve  — the same for mamba2-2.7b (64 layers, d 2560, 80 SSD heads
                 of 64, state 128, vocab 50280, bf16), after the qwen3-8b
                 engine is freed; every layer of every prefill chunk
                 launched the SSD kernel, and a prefix hit resumed from a
                 state page with zero copy bytes; then, the paged engine
                 freed, the ring engine on the same weights and prompts:
                 the SSD kernel in every layer of every prefill chunk from
                 the slot's state, no attention, hits seeded from point
                 snapshots (phases 11 and 12 likewise);
11. hybrid serve — the same for hymba-1.5b (32 layers, d 1600, 25/5 heads
                 of 64, sliding window 2048 except layers 0/15/31, 50 SSD
                 heads of 64, state 16, 128 meta tokens, vocab 32001, bf16),
                 after the mamba2 engine is freed: every layer of every
                 model call launched the attention kernel and every layer
                 of every prefill chunk the SSD kernel; the shared head ends
                 at position 160, a page boundary, so hits resume from a
                 state page; on the ring engine (rings of 256) the flash
                 forward in every layer of every first chunk, the position
                 mode in every layer of every later model call, the SSD
                 kernel in every layer of every prefill chunk;
12. mla serve  — the same for deepseek-v2-lite-16b (27 layers, d 2048, MLA
                 with 16 heads on a latent head of 512 + 64, MoE of 64
                 routed experts top-6 and 2 shared behind one dense layer,
                 vocab 102400, bf16, 15.7B parameters), after the hymba
                 engine is freed: every layer of every model call launched
                 the attention kernel at the latent head; on the ring
                 engine (rings of 128) the latent kernel in position mode
                 over one plane in every layer of every model call, no
                 flash forward;
13. moe serve  — mixtral-8x22b at full width (d 6144, GQA 48/8 at 128, MoE
                 of 8 experts top-2 of d_ff 16384 and no shared experts in
                 every layer, window 4096 everywhere, vocab 32768, bf16) cut
                 to its first 8 of 56 layers (20.4B parameters, 40.9 GB; the
                 memory plane meters all 56), after the deepseek engine is
                 freed: every layer of every model call launched the
                 attention kernel at a group of 6;
14. audio serve — musicgen-large at full width and depth (48 layers, d 2048,
                 MHA 32/32 at 64, ungated GELU d_ff 8192, 4 codebooks of
                 vocab 2048, bf16): a token is a 4-tuple, 8 x 16 positions
                 generated; the kernel at a group of 1;
15. vision serve — internvl2-76b at full width (d 8192, GQA 64/8 at 128,
                 d_ff 28672, vocab 128256, 256 zero patch embeddings in front
                 of every prompt, bf16) cut to its first 8 of 80 layers
                 (8.95B parameters, 17.9 GB): first chunks of up to 320 rows
                 over ten pages, hits resuming at 288; the kernel at a group
                 of 8;
15b. ring serve — gemma2-27b at full width and depth (46 layers, d 4608,
                 GQA 32/16 at 128, the 4096 window on alternate layers,
                 softcaps 50/30, post-norms, GeGLU d_ff 36864, vocab 256000,
                 bf16, 54.4 GB of weights drawn once), after the internvl2
                 engine is freed: the ring engine (``--paged-kernel off``,
                 rings of 4800 and 4096 slots), freed, then the paged engine,
                 on 4 prompts of 1000-4700 tokens (two past the window, one
                 a hit on the first) x 32 new tokens; the flash forward in
                 every layer of every first chunk and the position mode in
                 every layer of every later ring step; the window binds; the
                 ring hit copies a snapshot, the paged one nothing; both
                 engines run under the profiler, for their idle share;
16. train      — gemma-2b at full width and depth (18 layers, d 2048, MQA
                 8/1 at head_dim 256, GeGLU d_ff 16384, vocab 256000, bf16,
                 ``remat="full"``, AdamW) through ``repro_torch.launch.train``:
                 4 steps of 4 x 2048 tokens, after the serving engines are
                 freed; every layer of every step launched the forward
                 kernel twice (forward and recompute) and each backward
                 kernel once;
17. ssm, hybrid and audio train — mamba2-2.7b (64 layers, 4 steps of 4 x
                 2048 tokens), hymba-1.5b (32 layers, 3 steps of 2 x 2048
                 tokens behind 128 meta tokens) and musicgen-large (48
                 layers, 4 codebooks of 2048, 3 steps of 4 x 2048) at full
                 width and depth through ``repro_torch.launch.train``, bf16,
                 ``remat="full"``: every SSM layer of every step launched
                 the SSD forward twice and its backward once, every
                 attention layer the flash forward twice and dK/dV and dQ
                 once; finite losses and grad norms, mamba2's and
                 musicgen's step-0 loss within 3 of ln(vocab); step ms,
                 tokens/s and peak memory;
18. mla train  — deepseek-v2-lite-16b at full width cut to its first 6 of
                 27 layers (the dense layer and 5 MoE layers), bf16, 4 AdamW
                 steps of 4 x 2048 tokens, ``remat="full"``, through
                 ``train.step.make_train_step``: finite, step-0 loss within
                 3 of ln(vocab), aux loss positive, the flash forward twice
                 and dK/dV and dQ once per layer and step at Dk 192 / Dv
                 128, peak under 72 GB; step ms, tokens/s and peak;
19. dryrun     — the dry run (``repro_torch.launch.dryrun``, on this host's
                 CPU, nothing on the card): (a) gemma-2b x train_4k on the
                 16 x 16 production mesh (its verbose line: per-device GB,
                 the three roofline terms with the H100's datasheet
                 constants, the dominant one); (b) a mesh of one at each
                 training phase's configuration and batch (train, ssm_train,
                 hybrid_train, mla_train, audio_train), its predicted peak
                 and roofline bound beside the peak and steady step those
                 phases measured, and their ratios; (c) full-width gemma-2b
                 cut to 2 layers, one bf16 step on the card under
                 ``hlo_analysis.analyze``: its FLOPs and bytes must equal the
                 dry run's meta count of the same step, no collectives.

Then a ``phase_seconds`` line with each phase's wall time and the total,
a line ``{"kernels": [...]}`` with each kernel's launches (summed
over the paths that run it, each path's count beside), error and times,
the card's ``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero and prints no result line. It imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PAGE = 32            # --page-tokens default
HQ, HKV, D = 32, 8, 128          # qwen3-8b's attention geometry
HYMBA = (25, 5, 64)              # hymba-1.5b's: a group of 5 query heads, D 64
HYMBA_META = 128                 # its meta tokens: the first chunk is 160 rows
MLA = (16, 1, 576)               # deepseek-v2-lite-16b's absorbed MLA: 16 query heads
                                 # on one latent head [c, kr], r 512 + dr 64
MLA_REDUCED = (4, 1, 80)         # its reduced config's: r 64 + dr 16
MIXTRAL = (48, 8, 128)           # mixtral-8x22b's: a group of 6, window 4096
INTERNVL2 = (64, 8, 128)         # internvl2-76b's: a group of 8
INTERNVL2_IMAGE = 256            # its patch embeddings: the first chunk is 320 rows
MUSICGEN = (32, 32, 64)          # musicgen-large's MHA: a group of 1
SERVE_LAYERS = {"mixtral-8x22b": 8, "internvl2-76b": 8}   # cut depths on one card
GEMMA2 = (32, 16, 128)           # gemma2-27b's: a group of 2, softcap 50,
GEMMA2_CAP, GEMMA2_WINDOW = 50.0, 4096   # window 4096 on alternate layers
SCALES = {MLA: (128 + 64) ** -0.5, MLA_REDUCED: (32 + 16) ** -0.5,   # (dn + dr)^-1/2
          GEMMA2: (4608 / 32) ** -0.5}                                # (d / H)^-1/2
RING_PAGE = 32                   # the ring view's page: the serve default page_tokens
HBM_BYTES_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / fp32 (no TF32)
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# fp32: the kernel sums in another order than the plain version;
# bf16: about two bf16 ulps at magnitude 1 (both round the fp32 result
# once), the absolute part scaled by min(1, the case's max |out|)
SSD_H, SSD_P, SSD_N = 80, 64, 128   # mamba2-2.7b: 80 SSD heads of 64, state 128
SSD_CHUNK = 256                     # its ssm_chunk (and hymba-1.5b's)
SSD_HYMBA = {"H": 50, "P": 64, "N": 16, "G": 1}   # hymba-1.5b: 50 heads, state 16
SSD_TOL = 2e-4
# fp32 y and every final state: the reference's own SSD tolerance
# (tests/test_kernels.py), atol and rtol; bf16 y: rtol 2**-6 (two bf16 ulps
# of the value: both versions round one fp32 result once) and atol SSD_TOL
# times the largest |y| (fp32 sums taken in another order before rounding)


EMITTED: dict = {}   # each phase's line by name: the dry run reads the trains'


def emit(phase: str, **kw) -> None:
    EMITTED[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel cases at the main path's geometry
# ---------------------------------------------------------------------------


def make_case(torch, q_lens, kv_lens, dtype, *, geo=(HQ, HKV, D),
              extra_null=0, sparse=False, seed=0, page=PAGE):
    """A ragged batch on a shuffled pool of pages of ``page`` tokens at the
    attention geometry ``geo`` = (query heads, KV heads, head_dim):
    sequence s owns ceil(kv_lens[s] / page) pages at random pool ids; page
    0 stays the null page. ``extra_null`` pads every table row with
    trailing null slots; ``sparse`` nulls every other slot."""
    hq, hkv, d = geo
    g = torch.Generator().manual_seed(seed)
    n_pages = [-(-k // page) for k in kv_lens]
    W = max(n_pages) + extra_null
    P = 1 + sum(n_pages)
    perm = (1 + torch.randperm(P - 1, generator=g)).tolist()
    table = torch.zeros((len(kv_lens), W), dtype=torch.int32)
    for s, n in enumerate(n_pages):
        table[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    if sparse:
        table[:, 1::2] = 0
    pages = torch.randn((P, page, 2 * hkv, d), generator=g)
    pages[0] = 0
    q = torch.randn((sum(q_lens), hq, d), generator=g)
    cu = torch.tensor([0] + list(torch.tensor(q_lens).cumsum(0).tolist()),
                      dtype=torch.int32)
    kl = torch.tensor(kv_lens, dtype=torch.int32)
    return [q.to(dtype).cuda(), pages.to(dtype).cuda(), table.cuda(),
            cu.cuda(), kl.cuda()]


def work(case, dtype_name):
    """(bytes, flops) the function needs on this data (no window): q and
    out once, the small descriptors, and the K and V rows below
    ``kv_len`` in non-null pages, each once; 4*D flops per attended
    (query head, key)."""
    q, pages, table, cu, kl = case
    _, hq, d = q.shape
    item = q.element_size()
    ps = pages.shape[1]
    cu_l, kl_l, tbl = cu.tolist(), kl.tolist(), table.tolist()
    row_bytes = pages.shape[2] * d * item
    n_bytes = 2 * q.numel() * item + 4 * (table.numel() + cu.numel() + kl.numel())
    flops = 0
    for s, kv_len in enumerate(kl_l):
        qlen = cu_l[s + 1] - cu_l[s]
        for j, p in enumerate(tbl[s][:-(-kv_len // ps)]):
            if not p:
                continue
            n_bytes += row_bytes * (min(kv_len, (j + 1) * ps) - j * ps)
            flops += 4 * d * hq * sum(
                max(0, min(kv_len - qlen + i + 1, (j + 1) * ps) - j * ps)
                for i in range(qlen))
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return (n_bytes, flops, max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scale_of(geo) -> float:
    """The attention scale at a geometry: MLA's (dn + dr)^-1/2, else
    head_dim^-1/2."""
    return SCALES.get(geo, geo[2] ** -0.5)


def sdpa_backend(torch, call):
    """The first ``scaled_dot_product_attention`` backend, fastest first,
    that accepts ``call``'s inputs (flash and cuDNN take head dims up to
    256; a boolean mask rules flash out): (its name, ``call`` under it)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    refusals = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(backend=backend):
            with sdpa_kernel(backend):
                return call()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            refusals[backend.name] = str(e).splitlines()[0][:200]
            continue
        return backend.name, fn
    raise AssertionError(f"no scaled_dot_product_attention backend takes the inputs: "
                         f"{refusals}")


def time_ms(torch, fn, flush, iters=50, warmup=5):
    """Median per-call milliseconds over ``iters`` calls timed with CUDA
    events, the L2 cache flushed before each (a layer's pages arrive cold:
    36 layers of weights pass through L2 between two calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, flush, keep=None, iters=20):
    """Mean device milliseconds per call of ``fn``'s kernels (those whose
    profiler names pass ``keep``; by default all but the flush's), each
    call after an L2 flush: the card's own time, without the host's launch
    gaps that event timings of a few microseconds include on a slow host."""
    from torch.profiler import ProfilerActivity, profile

    def keys(work):
        work()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                work()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0}

    flush_keys = keys(flush.zero_)
    timed = keys(lambda: (flush.zero_(), fn()))
    keep = keep or (lambda key: key not in flush_keys)
    return sum(t for key, t in timed.items() if keep(key)) / iters / 1e3


def sdpa_inputs(torch, case):
    """The same KV gathered densely for one PyTorch library call
    (scaled_dot_product_attention), with a boolean mask for ragged
    lengths and causality. Timed beside the kernel; never used by the
    port."""
    q, pages, table, cu, kl = case
    _, hq, d = q.shape
    hkv = pages.shape[2] // 2
    cu_l, kl_l = cu.tolist(), kl.tolist()
    S = len(kl_l)
    qmax = max(cu_l[s + 1] - cu_l[s] for s in range(S))
    L = max(kl_l)
    k = torch.zeros((S, hkv, L, d), dtype=q.dtype, device=q.device)
    v = torch.zeros_like(k)
    qq = torch.zeros((S, hq, qmax, d), dtype=q.dtype, device=q.device)
    mask = torch.zeros((S, 1, qmax, L), dtype=torch.bool, device=q.device)
    ps = pages.shape[1]
    for s in range(S):
        n = -(-kl_l[s] // ps)
        kv = pages[table[s, :n].long()].reshape(n * ps, 2 * hkv, d)[:kl_l[s]]
        k[s, :, :kl_l[s]] = kv[:, 0::2].transpose(0, 1)
        v[s, :, :kl_l[s]] = kv[:, 1::2].transpose(0, 1)
        qlen = cu_l[s + 1] - cu_l[s]
        qq[s, :, :qlen] = q[cu_l[s]:cu_l[s + 1]].transpose(0, 1)
        qpos = kl_l[s] - qlen + torch.arange(qlen, device=q.device)
        mask[s, 0, :qlen] = (torch.arange(L, device=q.device)[None]
                             <= qpos[:, None])
    return qq, k, v, mask


def kernel_phase(torch, ops, ref, smi):
    rpa, rpa_ref = ops.ragged_paged_attention, ref.ragged_paged_attention_ref
    qwen = (HQ, HKV, D)
    decode = ([1, 1, 1, 1], [33, 77, 100, 128])
    mixed = ([5, 1, 48, 1], [37, 64, 80, 128])
    extend = ([48], [80])
    long = ([1, 1, 1, 1], [1000, 700, 1500, 333])   # more splits than one CTA takes
    # hymba-1.5b: a group of 5 query heads packed into the 16-row tiles, D 64;
    # decode behind the 128 meta tokens, the 160-row first chunk over five
    # pages, the 32-row chunk after it; a binding window of 64 and the
    # model's 2048
    h_decode = ([1, 1, 1, 1], [161, 183, 207, 230])
    h_first = ([HYMBA_META + PAGE], [HYMBA_META + PAGE])
    h_next = ([PAGE], [HYMBA_META + 2 * PAGE])
    # deepseek-v2-lite-16b's latent head (D 576, a group of 16: one decode
    # token is one 16-row tile) and its reduced config's (D 80): decode over
    # the serve traffic's lengths (a 32-token head, 8-47 prompt tokens, 16
    # new), a 32-row chunk over three pages, a whole prompt, long decodes
    # over many groups and, past 128 pages, several slots a split
    m_decode = ([1, 1, 1, 1], [41, 66, 80, 95])
    m_extend = ([32], [96])
    # and long MLA contexts: 32 sequences of 4096, a 64-token chunk (1,024
    # rows) at kv 4096; the latent head at pages of 16 and 64 tokens
    m_batch32 = ([1] * 32, [4096] * 32)
    m_chunk64 = ([64], [4096])
    cases = [("decode", qwen, decode, {}, {}),
             ("sparse_table", qwen, mixed, {"sparse": True}, {}),
             ("extend48", qwen, extend, {}, {}),
             ("decode_cap", qwen, decode, {}, {"cap": 30.0}),
             ("decode_window", qwen, decode, {}, {"window": 40}),
             ("extend48_cap_window", qwen, extend, {}, {"cap": 30.0, "window": 40}),
             ("long_decode", qwen, long, {}, {}),
             ("long_extend_window", qwen, ([20, 3], [1000, 600]), {}, {"window": 300}),
             # 128 pages and more: several slots a split
             ("multi_slot_splits", qwen, ([1, 3], [4500, 6000]), {}, {}),
             ("multi_slot_window", qwen, ([1, 20], [6000, 4200]), {}, {"window": 2500}),
             ("hymba_decode", HYMBA, h_decode, {}, {}),
             ("hymba_decode_window64", HYMBA, h_decode, {}, {"window": 64}),
             ("hymba_decode_window2048", HYMBA, h_decode, {}, {"window": 2048}),
             ("hymba_first_chunk", HYMBA, h_first, {}, {}),
             ("hymba_first_chunk_window64", HYMBA, h_first, {}, {"window": 64}),
             ("hymba_first_chunk_window2048", HYMBA, h_first, {}, {"window": 2048}),
             ("hymba_next_chunk_window64", HYMBA, h_next, {}, {"window": 64}),
             ("hymba_sparse_table", HYMBA, ([1, 32, 1], [161, 192, 230]),
              {"sparse": True}, {"window": 2048})]
    for tag, geo in (("mla", MLA), ("mla_reduced", MLA_REDUCED)):
        cases += [(f"{tag}_decode", geo, m_decode, {}, {}),
                  (f"{tag}_sparse_table", geo, ([5, 1, 32, 1], [37, 64, 96, 128]),
                   {"sparse": True}, {}),
                  (f"{tag}_extend32", geo, m_extend, {}, {}),
                  (f"{tag}_first_chunk", geo, ([70], [70]), {}, {}),
                  (f"{tag}_extend32_cap_window", geo, m_extend, {},
                   {"cap": 30.0, "window": 40}),
                  (f"{tag}_long_decode", geo, long, {}, {}),
                  (f"{tag}_multi_slot_splits", geo, ([1, 3], [4500, 6000]), {}, {})]
    cases += [("mla_decode_32x4096", MLA, m_batch32, {}, {}),
              ("mla_chunk64_4096", MLA, m_chunk64, {}, {}),
              ("mla_chunk64_4096_window", MLA, m_chunk64, {}, {"window": 1000})]
    # pages of 8 and 24 tokens: no TMA box, the latent kernel copies by hand
    for ps in (8, 16, 24, 64):
        cases += [(f"mla_decode_ps{ps}", MLA, m_decode, {"page": ps}, {}),
                  (f"mla_extend32_ps{ps}", MLA, m_extend, {"page": ps}, {}),
                  (f"mla_long_decode_ps{ps}", MLA, long, {"page": ps}, {}),
                  (f"mla_sparse_table_ps{ps}", MLA, ([5, 1, 32, 1], [37, 64, 96, 128]),
                   {"page": ps, "sparse": True}, {"window": 60})]
    # mixtral-8x22b (a group of 6: a decode token spans two 16-row tiles),
    # internvl2-76b (a group of 8; 256 patch embeddings, so the serve path's
    # first chunk is 320 rows over 10 pages and the chunk after it 64) and
    # musicgen-large (MHA, a group of 1: one row a KV head and token); the
    # serve lengths, and mixtral's window of 4096 binding over kv 4160-4700,
    # where whole pages fall below every query's window
    x_decode = ([1, 1, 1, 1], [4160, 4300, 4500, 4700])
    v_decode = ([1, 1, 1, 1], [297, 322, 336, 351])
    v_first = ([INTERNVL2_IMAGE + 64], [INTERNVL2_IMAGE + 64])
    v_next = ([64], [INTERNVL2_IMAGE + 128])
    cases += [("mixtral_decode", MIXTRAL, m_decode, {}, {}),
              ("mixtral_extend64", MIXTRAL, ([64], [96]), {}, {}),
              ("mixtral_sparse_table", MIXTRAL, ([5, 1, 32, 1], [37, 64, 96, 128]),
               {"sparse": True}, {}),
              ("mixtral_decode_window4096", MIXTRAL, x_decode, {}, {"window": 4096}),
              ("mixtral_extend64_window4096", MIXTRAL, ([64], [4700]), {},
               {"window": 4096}),
              ("internvl2_first_chunk", INTERNVL2, v_first, {}, {}),
              ("internvl2_next_chunk", INTERNVL2, v_next, {}, {}),
              ("internvl2_decode", INTERNVL2, v_decode, {}, {}),
              ("musicgen_decode", MUSICGEN, m_decode, {}, {}),
              ("musicgen_extend32", MUSICGEN, m_extend, {}, {})]
    errs, atols = {}, {}
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, geo, (ql, kl), mk, kw in cases:
            scale = scale_of(geo)
            case = make_case(torch, ql, kl, dtype, geo=geo, **mk)
            out = rpa(*case, scale=scale, max_q_len=max(ql), **kw)
            want = rpa_ref(*case, scale=scale, **kw)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            errs[f"{dname}/{name}"] = err
            max_err[dname] = max(max_err[dname], err)
            tol = TOL[dname]
            # bf16: the absolute part scales with the case's outputs (|out|
            # averages down to ~0.02 over thousands of keys), never above
            # the short decodes' limit
            atol = tol if dname == "float32" else tol * min(1.0, want.float().abs().max().item())
            atols[f"{dname}/{name}"] = atol
            if not torch.allclose(out.float(), want.float(), atol=atol, rtol=tol):
                raise AssertionError(f"{dname}/{name}: kernel vs plain max abs "
                                     f"err {err} over tolerance {atol} + {tol} |want|")
        for name, geo, (ql, kl) in (("decode", qwen, decode), ("extend48", qwen, extend),
                                    ("long_decode", qwen, long),
                                    ("hymba_decode", HYMBA, h_decode),
                                    ("hymba_first_chunk", HYMBA, h_first),
                                    ("mla_decode", MLA, m_decode),
                                    ("mla_extend32", MLA, m_extend),
                                    ("mla_long_decode", MLA, long),
                                    ("mla_reduced_decode", MLA_REDUCED, m_decode),
                                    ("mla_reduced_extend32", MLA_REDUCED, m_extend),
                                    ("mixtral_decode", MIXTRAL, m_decode),
                                    ("mixtral_long_decode", MIXTRAL, x_decode),
                                    ("internvl2_first_chunk", INTERNVL2, v_first),
                                    ("internvl2_decode", INTERNVL2, v_decode),
                                    ("musicgen_decode", MUSICGEN, m_decode),
                                    ("musicgen_extend32", MUSICGEN, m_extend)):
            scale = scale_of(geo)
            base = make_case(torch, ql, kl, dtype, geo=geo, seed=3)
            padded = make_case(torch, ql, kl, dtype, geo=geo, seed=3, extra_null=20)
            assert torch.equal(base[1], padded[1]) and torch.equal(base[0], padded[0])
            o0 = rpa(*base, scale=scale, max_q_len=max(ql))
            o4 = rpa(*padded, scale=scale, max_q_len=max(ql))
            if not torch.equal(o0, o4):
                raise AssertionError(f"{dname}/{name}: output changed under 20 "
                                     "trailing null table slots")
        # the last row of an extend launch (one CTA folds every group) and the
        # same row alone in a decode launch (the groups spread over CTAs)
        for geo, q_len, kv_len, window in ((qwen, 48, 80, None), (qwen, 48, 1000, None),
                                           (qwen, 48, 4500, None),
                                           (HYMBA, HYMBA_META + PAGE, HYMBA_META + PAGE, None),
                                           (HYMBA, PAGE, 230, 64),
                                           (MLA, 32, 96, None), (MLA, 70, 70, None),
                                           (MLA, 32, 4500, None),
                                           (MLA_REDUCED, 32, 96, None),
                                           (MIXTRAL, 64, 96, None),
                                           (MIXTRAL, 64, 4700, 4096),
                                           (INTERNVL2, INTERNVL2_IMAGE + 64,
                                            INTERNVL2_IMAGE + 64, None),
                                           (INTERNVL2, 64, INTERNVL2_IMAGE + 128, None),
                                           (MUSICGEN, 32, 96, None)):
            scale = scale_of(geo)
            q, pages, table, cu, kl = make_case(torch, [q_len], [kv_len], dtype,
                                                geo=geo, seed=4)
            ext = rpa(q, pages, table, cu, kl, scale=scale, max_q_len=q_len,
                      window=window)
            one = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
            dec = rpa(q[-1:].contiguous(), pages, table, one, kl, scale=scale,
                      max_q_len=1, window=window)
            if not torch.equal(ext[-1:], dec):
                raise AssertionError(f"{dname}: {geo}, kv {kv_len}, a row's "
                                     "decode and extend launches differ")
        # a sequence decoded alone and as one of a batch of 32 (lengths 96
        # to 4033: one split to 32), at the latent head
        kls = [96 + 127 * i for i in range(32)]
        q, pages, table, cu, kl = make_case(torch, [1] * 32, kls, dtype, geo=MLA, seed=7)
        batch = rpa(q, pages, table, cu, kl, scale=scale_of(MLA), max_q_len=1)
        one = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        for i in range(32):
            alone = rpa(q[i:i + 1].contiguous(), pages, table[i:i + 1].contiguous(), one,
                        kl[i:i + 1].contiguous(), scale=scale_of(MLA), max_q_len=1)
            if not torch.equal(batch[i:i + 1], alone):
                raise AssertionError(f"{dname}: MLA kv {kls[i]}: a sequence decoded "
                                     "alone differs from the same one in a batch of 32")
    emit("kernel_check", kernel="ragged_paged_attention", max_abs_err=errs,
         tolerance={"rtol": TOL, "atol": atols}, padding_bit_equal=True,
         decode_equals_extend_row=True, alone_equals_batch32=True)

    # -- times at the main paths' bf16 shapes ----------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    serve4 = ([1, 1, 1, 1], [72, 80, 88, 96])
    shapes = [("decode", qwen, serve4), ("extend", qwen, ([48], [80])),
              ("long_decode", qwen, ([1, 1, 1, 1], [4096] * 4)),
              ("hymba_decode", HYMBA, ([1, 1, 1, 1], [170, 190, 210, 230])),
              ("hymba_first_chunk", HYMBA, h_first),
              ("mla_decode", MLA, serve4), ("mla_extend32", MLA, m_extend),
              ("mla_long_decode", MLA, ([1, 1, 1, 1], [4096] * 4)),
              ("mla_decode_32x4096", MLA, m_batch32), ("mla_chunk64_4096", MLA, m_chunk64),
              ("mixtral_decode", MIXTRAL, serve4),
              ("internvl2_decode", INTERNVL2, ([1, 1, 1, 1], [328, 336, 344, 352])),
              ("internvl2_first_chunk", INTERNVL2, v_first),
              ("musicgen_decode", MUSICGEN, serve4),
              # gemma2-27b's paged decode at the ring case's lengths
              ("gemma2_decode", GEMMA2, ([1, 1, 1, 1], [1000, 2300, 3700, 4700]))]
    shapes = [(*sh, PAGE) for sh in shapes] + [
        (f"mla_{tag}_ps{ps}", MLA, shape, ps) for ps in (16, 64)
        for tag, shape in (("decode", serve4), ("extend32", m_extend),
                           ("long_decode", ([1, 1, 1, 1], [4096] * 4)))]
    for name, geo, (ql, kl), ps in shapes:
        scale = scale_of(geo)
        case = make_case(torch, ql, kl, torch.bfloat16, geo=geo, seed=5, page=ps)
        n_bytes, flops, bound_ms, bound_by = work(case, "bfloat16")
        qq, k, v, mask = sdpa_inputs(torch, case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qq, k, v, attn_mask=mask, scale=scale,  # noqa: E731
                           enable_gqa=True)
        backend = None
        if geo == MLA:     # D 576: name the backend that takes it
            backend, lib = sdpa_backend(torch, lib)
        kernel = lambda: rpa(*case, scale=scale, max_q_len=max(ql))  # noqa: E731
        # the plain version loops over the table's slots: a couple of calls
        # at 32 x 4096
        plain_iters = 2 if len(kl) * max(kl) > 4 * 4096 else 20
        timing[name] = {
            "geometry": list(geo), "q_lens": ql if len(ql) <= 4 else f"{len(ql)} x {ql[0]}",
            "kv_lens": kl if len(kl) <= 4 else f"{len(kl)} x {kl[0]}", "page_size": ps,
            "bytes": n_bytes, "library_backend": backend, "flops": flops,
            "ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, lambda: rpa_ref(*case, scale=scale),
                                flush, iters=plain_iters, warmup=min(5, plain_iters)),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # the card's time alone (every ragged_paged_attention kernel of the call)
            "device_ms": device_ms(torch, kernel, flush,
                                   lambda key: "ragged_paged_attention" in key),
            "library_device_ms": device_ms(torch, lib, flush),
        }
        del case, qq, k, v, mask
    emit("kernel_time", kernel="ragged_paged_attention", dtype="bfloat16",
         nvidia_smi=smi, shapes=timing)
    return max_err, timing


# ---------------------------------------------------------------------------
# Launch plans (tune.py) and the gather count, at the served geometries
# ---------------------------------------------------------------------------

# (name, geometry, page size): qwen3-8b at pages of 64 and at the serve
# default of 32, hymba-1.5b (D 64, a group of 5) at 32
TUNE_GEOS = (("qwen3-8b_ps64", (HQ, HKV, D), 64), ("qwen3-8b_ps32", (HQ, HKV, D), PAGE),
             ("hymba-1.5b_ps32", HYMBA, PAGE))
# decode over 1 to 4 slots a split; a sparse-table extend; a binding
# window; the explicit-position mode (the ring view's), page 0 included
TUNE_CASES = {"decode": (([1, 1, 1, 1], [100, 1500, 4500, 9000]), {}, {}),
              "sparse_extend": (([5, 1, 48, 20], [37, 64, 600, 900]), {"sparse": True}, {}),
              "window": (([20, 3, 1], [1000, 600, 4500]), {}, {"window": 300}),
              "positions": (([5, 1, 48], [37, 900, 4100]), {"sparse": True},
                            {"positions": True})}


def tile_plans(tune, ops, dtype):
    """The (block_q, num_buffers, head dim) plans the tiles library of
    ``dtype`` instantiates: every plan but the default one that fits the
    card, at every head dim of the per-warp kernels."""
    return [(bq, nb, d) for bq in tune.CANDIDATE_BLOCK_Q for nb in tune.CANDIDATE_BUFFERS
            for d in ops._HEAD_DIMS
            if (bq, nb) != (tune.MMA_ROWS, 2) and not tune.is_latent(d, dtype)
            and (bq == tune.MMA_ROWS or d <= tune.WIDE_MAX_D)
            and tune.smem_bytes(d, dtype, bq, nb) <= tune.SMEM_BYTES]


def slot_positions(torch, case):
    """A make_case batch's slot-derived positions written out as explicit
    ones (``q_pos``, ``kv_pos_pages``): the key at row r of the page in slot
    j sits at j * ps + r below kv_len, every other row -1."""
    q, pages, table, cu, kl = case
    ps = pages.shape[1]
    kv_pos = torch.full((pages.shape[0], ps), -1, dtype=torch.int32)
    q_pos = []
    cu_l, kl_l, tbl = cu.tolist(), kl.tolist(), table.tolist()
    for s, kv_len in enumerate(kl_l):
        for j, p in enumerate(tbl[s][:-(-kv_len // ps)]):
            if p:
                n = min(ps, kv_len - j * ps)
                kv_pos[p, :n] = torch.arange(j * ps, j * ps + n, dtype=torch.int32)
        q_pos += range(kv_len - (cu_l[s + 1] - cu_l[s]), kv_len)
    return torch.tensor(q_pos, dtype=torch.int32).cuda(), kv_pos.cuda()


def tune_phase(torch, ops, ref, tune, smi):
    """The launch plans on the card. At each of ``TUNE_GEOS``, in bf16 and
    fp32, every candidate plan (tune.py's grid, as the card resolves it) on
    each of ``TUNE_CASES``: agrees with the plain version within the
    tolerance, is bit-equal across two launches and to the default rows
    and stages at the same block_kv (a row's bits depend on its split
    boundaries alone), and its ``gathered`` counter equals
    ``pages_gathered``. The latent kernel's counter likewise, on its own
    plan, one plane and two. Then ``autotune`` on a decode and an extend
    case at each geometry (bf16): every candidate's device ms beside the
    default's, and the winner. The tuned plans are dropped at the end, so
    the phases after this one launch the default plan. Returns the tuning
    results by geometry."""
    import dataclasses
    rpa, rpa_ref = ops.ragged_paged_attention, ref.ragged_paged_attention_ref
    grid = [tune.KernelConfig(bq, bkv, nb) for bq in tune.CANDIDATE_BLOCK_Q
            for bkv in tune.CANDIDATE_BLOCK_KV for nb in tune.CANDIDATE_BUFFERS]

    def launch(case, pos, geo, ql, kw, plan=None, gathered=None, v_from_k=False):
        extra = dict(q_pos=pos[0], kv_pos_pages=pos[1]) if pos else {}
        plan = {} if plan is None else dict(block_q=plan.block_q, block_kv=plan.block_kv,
                                            num_buffers=plan.num_buffers)
        return rpa(*case, scale=scale_of(geo), max_q_len=max(ql), v_from_k=v_from_k,
                   gathered=gathered, **extra, **plan, **kw)

    def counted(case, pos, geo, ql, kw, plan=None, v_from_k=False):
        n = torch.zeros(1, dtype=torch.int32, device="cuda")
        out = launch(case, pos, geo, ql, kw, plan, n, v_from_k)
        torch.cuda.synchronize()
        return out, int(n.item())

    def replica(case, geo, ql, dtype, kw, pos, plan=None):
        _, pages, table, cu, kl = case
        return ops.pages_gathered(
            table, cu, kl, page_size=pages.shape[1], max_q_len=max(ql),
            block_q=plan and plan.block_q, block_kv=plan and plan.block_kv,
            window=kw.get("window"), num_q_heads=geo[0], num_kv_heads=geo[1],
            head_dim=geo[2], dtype=dtype, positions=pos is not None,
            num_pages=pages.shape[0])

    saved = dict(tune._CACHE)
    checks, errs, counts, tuned = {}, {}, {}, {}
    try:
        for gname, geo, ps in TUNE_GEOS:
            for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                for cname, ((ql, kl), mk, kw) in TUNE_CASES.items():
                    kw = dict(kw)
                    case = make_case(torch, ql, kl, dtype, geo=geo, page=ps, seed=11, **mk)
                    pos = slot_positions(torch, case) if kw.pop("positions", False) else None
                    extra = dict(q_pos=pos[0], kv_pos_pages=pos[1]) if pos else {}
                    want = rpa_ref(*case, scale=scale_of(geo), **extra, **kw).float()
                    tol = TOL[dname]
                    atol = tol if dname == "float32" else tol * min(1.0, want.abs().max().item())
                    base = {}
                    tag = f"{gname}/{dname}/{cname}"
                    for plan in grid:
                        eff = tune.resolve_config(ps, geo[2], max(ql), case[2].shape[1],
                                                  plan.block_q, plan.block_kv,
                                                  plan.num_buffers, dtype=dtype,
                                                  group=geo[0] // geo[1])
                        out, n = counted(case, pos, geo, ql, kw, plan)
                        again = launch(case, pos, geo, ql, kw, plan)
                        if eff.block_kv not in base:
                            base[eff.block_kv] = launch(case, pos, geo, ql, kw, tune.KernelConfig(
                                16, eff.block_kv, 2))
                        key = f"{tag}/{eff.block_q},{eff.block_kv},{eff.num_buffers}"
                        errs[key] = (out.float() - want).abs().max().item()
                        counts[key] = n
                        checks[f"{key} close"] = torch.allclose(out.float(), want, atol=atol,
                                                                rtol=tol)
                        checks[f"{key} bit-stable"] = torch.equal(out, again)
                        checks[f"{key} default bits"] = torch.equal(out, base[eff.block_kv])
                        checks[f"{key} gathered"] = n == replica(case, geo, ql, dtype, kw,
                                                                 pos, plan) > 0
                    del case, want, base
        # the latent kernel (bf16 D 576) on its own plan, one plane and two
        for cname, ((ql, kl), mk, kw) in TUNE_CASES.items():
            kw = dict(kw)
            case = make_case(torch, ql, kl, torch.bfloat16, geo=MLA, seed=12, **mk)
            pos = slot_positions(torch, case) if kw.pop("positions", False) else None
            for planes, v_from_k in ((2, False), (1, True)):
                args = case if not v_from_k else [case[0], case[1][:, :, :1].contiguous(),
                                                  *case[2:]]
                _, n = counted(args, pos, MLA, ql, kw, v_from_k=v_from_k)
                key = f"mla/bfloat16/{cname}/planes{planes}"
                counts[key] = n
                checks[f"{key} gathered"] = n == replica(case, MLA, ql, torch.bfloat16, kw,
                                                         pos) > 0
            del case
        emit("tune_check", kernel="ragged_paged_attention", max_abs_err=errs,
             tolerance=TOL, gathered=counts)
        _require("tune", checks)
        for gname, geo, ps in TUNE_GEOS:
            hq, hkv, d = geo
            # decode and a ragged extend at 2048 keys, and decode at 16384
            # (256 or 512 pages: splits of up to 4 or 8 slots, where
            # block_kv decides)
            cases = [tune._bench_case(ps, d, device="cuda", n_kv_heads=hkv, group=hq // hkv,
                                      seqs=4, pages_per_seq=keys // ps, decode=dec, seed=13)
                     for keys, dec in ((2048, True), (2048, False), (16384, True))]
            default = tune.resolve_config(ps, d, 1 << 20, tune.MAX_SPLIT_SLOTS,
                                          *dataclasses.astuple(tune.KernelConfig()))
            timings = {}
            win = tune.autotune(ps, d, cases=cases, timings=timings, cache_path="")
            tuned[gname] = {
                "page_size": ps, "geometry": list(geo), "device_name": tune._arch(),
                "cases": [{"q_lens": c["cu_q_lens"].diff().tolist(),
                           "kv_lens": c["kv_lens"].tolist()} for c in cases],
                "default": [default.block_q, default.block_kv, default.num_buffers],
                "default_ms": timings[default],
                "winner": [win.block_q, win.block_kv, win.num_buffers],
                "winner_ms": timings[win],
                "candidates_ms": {f"{c.block_q},{c.block_kv},{c.num_buffers}": ms
                                  for c, ms in timings.items()}}
            del cases
    finally:
        tune._CACHE.clear()
        tune._CACHE.update(saved)
    emit("tune", nvidia_smi=smi, dtype="bfloat16", timing="CUDA events over 20 rounds "
         "of the cases behind a device sleep: ms a round, device time", geometries=tuned)
    return tuned


# ---------------------------------------------------------------------------
# The explicit-position mode: rings viewed as pages (gemma2-27b's geometry)
# ---------------------------------------------------------------------------


def ring_case(torch, spans, q_lens, C, dtype, *, geo=GEMMA2, empty=0.0, ahead=None,
              seed=0):
    """B rings of C slots at gemma2-27b's geometry, viewed as pages of
    RING_PAGE slots as ``kernels/decode_attention`` views them: ring b
    holds positions ``range(*spans[b])`` at slot p % C (a span longer than
    C wraps it; a shorter one leaves -1 slots), a fraction ``empty`` of
    slots is emptied, and its q_lens[b] queries end ``ahead[b]`` (default
    0) positions past its newest key. Returns ([q, kv_pages, table, cu, kv_lens], q_pos, kv_pos)
    on the card."""
    hq, hkv, d = geo
    g = torch.Generator().manual_seed(seed)
    B, n_per = len(spans), C // RING_PAGE
    pos = torch.full((B, C), -1, dtype=torch.int32)
    q_pos = []
    for b, (lo, hi) in enumerate(spans):
        p = torch.arange(max(lo, hi - C), hi, dtype=torch.int32)
        pos[b, p.long() % C] = p
        last = hi + (ahead[b] if ahead else 0)
        q_pos += list(range(last - q_lens[b], last))
    if empty:
        pos[torch.rand((B, C), generator=g) < empty] = -1
    pages = torch.randn((B * n_per, RING_PAGE, 2 * hkv, d), generator=g)
    q = torch.randn((sum(q_lens), hq, d), generator=g)
    cu = torch.tensor([0] + list(torch.tensor(q_lens).cumsum(0).tolist()),
                      dtype=torch.int32)
    table = torch.arange(B * n_per, dtype=torch.int32).reshape(B, n_per)
    kv_lens = torch.full((B,), C, dtype=torch.int32)
    return ([q.to(dtype).cuda(), pages.to(dtype).cuda(), table.cuda(), cu.cuda(),
             kv_lens.cuda()], torch.tensor(q_pos, dtype=torch.int32).cuda(),
            pos.reshape(B * n_per, RING_PAGE).cuda())


def ring_masks(torch, case, q_pos, kv_pos, window):
    """(per sequence, the (S, C) boolean mask the stored positions give) —
    what the kernel attends, for the byte count and the library call."""
    _, _, table, cu, _ = case
    cu_l = cu.tolist()
    out = []
    for b in range(table.shape[0]):
        kp = kv_pos[table[b].long()].reshape(-1)
        qp = q_pos[cu_l[b]:cu_l[b + 1]]
        m = (kp[None] >= 0) & (kp[None] <= qp[:, None])
        if window is not None:
            m &= kp[None] > qp[:, None] - window
        out.append(m)
    return out


def ring_work(torch, case, q_pos, kv_pos, window, dtype_name):
    """(bytes, flops, bound ms, bound_by) of one position-mode call: the K/V
    rows that some query of their sequence attends (a stored position >= 0
    inside at least one query's window: empty slots and keys behind every
    window are not needed), the whole position plane, q and the
    descriptors read once, the output written once; 4*D flops per (query
    head, visible key)."""
    q, pages, table, cu, kl = case
    _, hq, d = q.shape
    masks = ring_masks(torch, case, q_pos, kv_pos, window)
    needed = sum(int(m.any(0).sum()) for m in masks)
    row_bytes = pages[0, 0].numel() * pages.element_size()
    n_bytes = (2 * q.numel() * q.element_size() + needed * row_bytes
               + 4 * (kv_pos.numel() + q_pos.numel() + table.numel() + cu.numel()
                      + kl.numel()))
    flops = 4 * d * hq * sum(int(m.sum()) for m in masks)
    return (n_bytes, flops, *_bound(flops, n_bytes, dtype_name))


def ring_sdpa(torch, case, q_pos, kv_pos, scale, window):
    """One ``scaled_dot_product_attention`` call on the same rings with a
    boolean mask from the stored positions (no softcap: SDPA has none).
    Inputs laid out outside the timed call; never used by the port."""
    q, pages, table, cu, _ = case
    _, hq, d = q.shape
    hkv = pages.shape[2] // 2
    B, S = table.shape[0], int(cu[1] - cu[0])
    kv = pages[table.long()].reshape(B, -1, 2 * hkv, d)
    k = kv[:, :, 0::2].transpose(1, 2).contiguous()
    v = kv[:, :, 1::2].transpose(1, 2).contiguous()
    qq = q.reshape(B, S, hq, d).transpose(1, 2).contiguous()
    mask = torch.stack(ring_masks(torch, case, q_pos, kv_pos, window))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def ring_kernel_phase(torch, ops, ref, ring_view, smi):
    """The explicit-position mode at gemma2-27b's geometry (32/16 heads, D
    128, softcap 50), fp32 and bf16, against the plain version: a wrapped
    ring under the 4096 window (positions p % 4096 for p in 600..4695,
    queries up to 120 past the newest key, so the window masks up to 120
    of them), a 4800-slot ring with empty slots, 4-sequence decodes, a
    504-row extend chunk; and where the positions are the slot-derived
    ones, bit-equal to the slot-derived mode on the same pages. Times the
    bf16 cases: the kernel (events and device time), the ring path's whole
    call (``ring_view.decode_attention``/``extend_attention`` on the fused
    ring, which it views as the pages without a copy; bit-equal to the
    kernel's output), the plain version and SDPA with the stored
    positions' mask."""
    rpa, rpa_ref = ops.ragged_paged_attention, ref.ragged_paged_attention_ref
    scale = scale_of(GEMMA2)
    W = GEMMA2_WINDOW
    cases = {   # name: (spans, q_lens, C, empty, queries past the newest key, window)
        "wrapped_window_decode": ([(600, 4696)] * 4, [1] * 4, 4096, 0.0,
                                  [0, 40, 80, 120], W),
        "empty_slots_decode": ([(0, n) for n in (1000, 2300, 3700, 4700)], [1] * 4,
                               4800, 0.02, None, None),
        "wrapped_window_extend504": ([(1112, 5208)], [504], 4096, 0.0, None, W),
        "global_extend504": ([(0, 4704)], [504], 4800, 0.0, None, None),
    }
    errs, atols, max_err = {}, {}, {"float32": 0.0, "bfloat16": 0.0}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, (spans, ql, C, empty, ahead, window) in cases.items():
            case, q_pos, kv_pos = ring_case(torch, spans, ql, C, dtype, empty=empty,
                                            ahead=ahead)
            kw = dict(scale=scale, cap=GEMMA2_CAP, window=window, q_pos=q_pos,
                      kv_pos_pages=kv_pos)
            out = rpa(*case, max_q_len=max(ql), **kw)
            want = rpa_ref(*case, **kw)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            errs[f"{dname}/{name}"] = err
            max_err[dname] = max(max_err[dname], err)
            tol = TOL[dname]
            atol = tol if dname == "float32" else tol * min(1.0, want.float().abs().max().item())
            atols[f"{dname}/{name}"] = atol
            if not torch.allclose(out.float(), want.float(), atol=atol, rtol=tol):
                raise AssertionError(f"{dname}/{name}: position mode vs plain max abs "
                                     f"err {err} over tolerance {atol} + {tol} |want|")
        # slot-derived positions written out: bit-equal to the slot-derived mode
        for name, (ql, kl, window) in {"decode": ([1, 1, 1, 1], [33, 700, 4100, 4700], W),
                                       "extend504": ([504], [4700], W),
                                       "mixed": ([5, 1, 48, 1], [37, 64, 80, 4500], None)}.items():
            case = make_case(torch, ql, kl, dtype, geo=GEMMA2, seed=6, extra_null=3)
            _, pages, table, cu, kvl = case
            kv_pos = torch.full(pages.shape[:2], -1, dtype=torch.int32, device="cuda")
            for b, n in enumerate(kvl.tolist()):
                for j in range(-(-n // PAGE)):
                    kv_pos[table[b, j].long()] = j * PAGE + torch.arange(
                        PAGE, dtype=torch.int32, device="cuda")
            q_pos = torch.cat([torch.arange(n - q, n, dtype=torch.int32, device="cuda")
                               for q, n in zip(ql, kvl.tolist())])
            kw = dict(scale=scale, cap=GEMMA2_CAP, window=window, max_q_len=max(ql))
            slot = rpa(*case, **kw)
            pos = rpa(*case, q_pos=q_pos, kv_pos_pages=kv_pos, **kw)
            if not torch.equal(slot, pos):
                raise AssertionError(f"{dname}/{name}: slot-derived positions in "
                                     "position mode differ from the slot-derived mode")
    emit("kernel_check", kernel="ragged_paged_attention", mode="explicit positions",
         geometry=list(GEMMA2), cap=GEMMA2_CAP, max_abs_err=errs,
         tolerance={"rtol": TOL, "atol": atols}, slot_positions_bit_equal=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for name, (spans, ql, C, empty, ahead, window) in cases.items():
        case, q_pos, kv_pos = ring_case(torch, spans, ql, C, torch.bfloat16,
                                        empty=empty, ahead=ahead, seed=5)
        kw = dict(scale=scale, cap=GEMMA2_CAP, window=window, q_pos=q_pos,
                  kv_pos_pages=kv_pos)
        n_bytes, flops, bound_ms, bound_by = ring_work(torch, case, q_pos, kv_pos,
                                                       window, "bfloat16")
        kernel = lambda: rpa(*case, max_q_len=max(ql), **kw)  # noqa: E731
        lib = ring_sdpa(torch, case, q_pos, kv_pos, scale, window)
        q, pages = case[0], case[1]
        B, S = len(spans), ql[0]
        ring, ring_pos = pages.reshape(B, C, *pages.shape[2:]), kv_pos.reshape(B, C)
        entry = ring_view.decode_attention if S == 1 else ring_view.extend_attention
        view = lambda: entry(q.reshape(B, S, *q.shape[1:]), ring, ring_pos,  # noqa: E731
                             q_pos if S == 1 else q_pos[:S], scale=scale, cap=GEMMA2_CAP,
                             window=window, page_size=RING_PAGE)
        if not torch.equal(view().reshape(q.shape), kernel()):
            raise AssertionError(f"{name}: the ring view's output differs from the "
                                 "kernel's on the same pages")
        timing[name] = {
            "geometry": list(GEMMA2), "ring_slots": C, "q_lens": ql, "window": window,
            "bytes": n_bytes, "flops": flops,
            "ms": time_ms(torch, kernel, flush),
            "view_ms": time_ms(torch, view, flush),
            "plain_ms": time_ms(torch, lambda: rpa_ref(*case, **kw), flush, iters=5,
                                warmup=1),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": device_ms(torch, kernel, flush,
                                   lambda key: "ragged_paged_attention" in key),
            "library_device_ms": device_ms(torch, lib, flush),
        }
        del case, q_pos, kv_pos, lib, view, q, pages, ring, ring_pos
    emit("kernel_time", kernel="ragged_paged_attention", mode="explicit positions",
         dtype="bfloat16", nvidia_smi=smi, shapes=timing)
    return max_err, timing


LATENT_R = {MLA: 512, MLA_REDUCED: 64}   # the latent rank r of [c, kr]
LATENT_RING = 128                        # deepseek's serve ring: 4 pages of 32
HYMBA_RING = 256                         # hymba's: 128 meta + 32 + 48 + 16 fit


def latent_planes(torch, pages, r):
    """A ring's latent rows as the two layouts the kernel reads: one plane
    [c, kr] (P, ps, 1, D), and the paged pool's two, [c, kr] and [c, 0]."""
    one = pages[:, :, :1].contiguous()
    two = torch.cat([one, one], dim=2)
    two[:, :, 1, r:] = 0
    return one, two


def latent_sdpa(torch, case, q_pos, kv_pos, scale, window):
    """One ``scaled_dot_product_attention`` call on a latent ring (one
    plane: K = V = [c, kr]; two: K = [c, kr], V = [c, 0]) with the stored
    positions' mask, under the first backend that takes D 576 (or 80).
    Inputs laid out outside the timed call; never used by the port.
    Returns (backend name, call)."""
    q, pages, table, cu, _ = case
    _, hq, d = q.shape
    B, S = table.shape[0], int(cu[1] - cu[0])
    kv = pages[table.long()].reshape(B, -1, pages.shape[2], d)
    k, v = (kv[:, :, i:i + 1].transpose(1, 2).contiguous() for i in (0, kv.shape[2] - 1))
    qq = q.reshape(B, S, hq, d).transpose(1, 2).contiguous()
    mask = torch.stack(ring_masks(torch, case, q_pos, kv_pos, window))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return sdpa_backend(torch, lambda: sdpa(qq, k, v, attn_mask=mask, scale=scale,
                                            enable_gqa=True))


def latent_ring_kernel_phase(torch, ops, ref, smi):
    """The explicit-position mode on rings of the two geometries this slice
    adds, fp32 and bf16, against the plain version:

    - deepseek-v2-lite-16b's latent head (16 query heads on one KV head of
      D 576; the bf16 latent kernel, the fp32 kernel) and its reduced D 80,
      on 128-slot rings read as 4 pages of 32: decodes of 4 over rings with
      empty slots, over wrapped rings, and a 48-row extend, and (D 576)
      decodes of 4 over wrapped 4096-slot rings, full and 2% empty; each in
      one plane (V from K, ``v_from_k``: the ring) and in two ([c, kr] / [c,
      0]: the paged pool's layout), whose lanes [0, r) must be bit-equal;
      and, on pages of the paged layout, the slot-derived positions written
      out bit-equal to the slot-derived mode, in both layouts;
    - hymba-1.5b's attention (25/5 heads at D 64) on 256-slot rings under
      its window of 2048 (and a binding 64): decode of 4 and a 32-row chunk.

    Every output is bit-stable across two launches. Times the bf16 latent
    decode (the serve ring's lengths, and 4096-slot rings) and extend, one
    plane and two, the hymba decode: kernel (events and device time), plain
    version, SDPA with the stored positions' mask, bound."""
    rpa, rpa_ref = ops.ragged_paged_attention, ref.ragged_paged_attention_ref
    C = LATENT_RING
    cases = {   # name: (geo, spans, q_lens, ring slots, empty, window)
        "decode_empty": ([(0, n) for n in (41, 66, 80, 95)], [1] * 4, C, 0.05, None),
        "decode_wrapped": ([(0, n) for n in (150, 200, 260, 129)], [1] * 4, C, 0.0, None),
        "extend48": ([(0, 96)], [48], C, 0.0, None),
        "extend48_wrapped": ([(40, 200)], [48], C, 0.0, None),
    }
    all_cases = [(f"{tag}_{name}", geo, *rest) for tag, geo in (("mla", MLA),
                                                                ("mla_reduced", MLA_REDUCED))
                 for name, rest in cases.items()]
    # four wrapped 4096-slot rings: the long latent decode the ring path reads
    ring4096 = [(0, n) for n in (4096, 4500, 5000, 6000)]
    all_cases += [("mla_decode_4096", MLA, ring4096, [1] * 4, 4096, 0.0, None),
                  ("mla_decode_4096_empty", MLA, ring4096, [1] * 4, 4096, 0.02, None)]
    all_cases += [("hymba_decode_window2048", HYMBA, [(0, n) for n in (161, 183, 207, 230)],
                   [1] * 4, HYMBA_RING, 0.02, 2048),
                  ("hymba_decode_window64", HYMBA, [(0, n) for n in (161, 183, 207, 230)],
                   [1] * 4, HYMBA_RING, 0.0, 64),
                  ("hymba_extend32_window2048", HYMBA, [(0, 224)], [32], HYMBA_RING, 0.0,
                   2048)]
    errs, atols, max_err = {}, {}, {"float32": 0.0, "bfloat16": 0.0}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, geo, spans, ql, ring, empty, window in all_cases:
            case, q_pos, kv_pos = ring_case(torch, spans, ql, ring, dtype, geo=geo,
                                            empty=empty)
            kw = dict(scale=scale_of(geo), window=window, q_pos=q_pos,
                      kv_pos_pages=kv_pos)
            layouts = {"": (case[1], False)}
            if geo in LATENT_R:
                one, two = latent_planes(torch, case[1], LATENT_R[geo])
                layouts = {"/one_plane": (one, True), "/two_planes": (two, False)}
            outs = {}
            for lname, (pages, v_from_k) in layouts.items():
                args = [case[0], pages, *case[2:]]
                out = rpa(*args, max_q_len=max(ql), v_from_k=v_from_k, **kw)
                again = rpa(*args, max_q_len=max(ql), v_from_k=v_from_k, **kw)
                want = rpa_ref(*args, v_from_k=v_from_k, **kw)
                torch.cuda.synchronize()
                key = f"{dname}/{name}{lname}"
                if not torch.equal(out, again):
                    raise AssertionError(f"{key}: two launches differ")
                err = (out.float() - want.float()).abs().max().item()
                errs[key] = err
                max_err[dname] = max(max_err[dname], err)
                tol = TOL[dname]
                atol = tol if dname == "float32" else tol * min(1.0, want.float().abs().max().item())
                atols[key] = atol
                if not torch.allclose(out.float(), want.float(), atol=atol, rtol=tol):
                    raise AssertionError(f"{key}: position mode vs plain max abs err "
                                         f"{err} over tolerance {atol} + {tol} |want|")
                outs[lname] = out
            if geo in LATENT_R:
                r = LATENT_R[geo]
                if not torch.equal(outs["/one_plane"][..., :r], outs["/two_planes"][..., :r]):
                    raise AssertionError(f"{dname}/{name}: one plane and two differ in "
                                         "lanes [0, r)")
        # slot-derived positions written out, in both latent layouts
        for tag, geo in (("mla", MLA), ("mla_reduced", MLA_REDUCED)):
            for name, (ql, kl, window) in {"decode": ([1] * 4, [41, 66, 80, 95], None),
                                           "extend32": ([32], [96], None),
                                           "mixed_window": ([5, 1, 32, 1],
                                                            [37, 64, 96, 128], 40)}.items():
                case = make_case(torch, ql, kl, dtype, geo=geo, seed=6, extra_null=3)
                _, pages, table, cu, kvl = case
                kv_pos = torch.full(pages.shape[:2], -1, dtype=torch.int32, device="cuda")
                for b, n in enumerate(kvl.tolist()):
                    for j in range(-(-n // PAGE)):
                        kv_pos[table[b, j].long()] = j * PAGE + torch.arange(
                            PAGE, dtype=torch.int32, device="cuda")
                q_pos = torch.cat([torch.arange(n - q, n, dtype=torch.int32, device="cuda")
                                   for q, n in zip(ql, kvl.tolist())])
                one, two = latent_planes(torch, pages, LATENT_R[geo])
                for lname, pp, v_from_k in (("one_plane", one, True),
                                            ("two_planes", two, False)):
                    args = [case[0], pp, table, cu, kvl]
                    kw = dict(scale=scale_of(geo), window=window, max_q_len=max(ql),
                              v_from_k=v_from_k)
                    if not torch.equal(rpa(*args, **kw),
                                       rpa(*args, q_pos=q_pos, kv_pos_pages=kv_pos, **kw)):
                        raise AssertionError(f"{dname}/{tag}_{name}/{lname}: slot-derived "
                                             "positions differ from the slot-derived mode")
    emit("kernel_check", kernel="ragged_paged_attention",
         mode="explicit positions: latent head (one and two planes), hymba",
         geometry={"mla": list(MLA), "mla_reduced": list(MLA_REDUCED),
                   "hymba": list(HYMBA)}, max_abs_err=errs,
         tolerance={"rtol": TOL, "atol": atols}, one_plane_equals_two_in_latent_lanes=True,
         slot_positions_bit_equal=True, repeat_launches_bit_equal=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for name, geo, spans, ql, ring, window in (
            ("mla_decode", MLA, [(0, n) for n in (72, 80, 88, 96)], [1] * 4, C, None),
            ("mla_extend48", MLA, [(0, 96)], [48], C, None),
            ("mla_decode_4096", MLA, ring4096, [1] * 4, 4096, None),
            ("hymba_decode", HYMBA, [(0, n) for n in (170, 190, 210, 230)], [1] * 4,
             HYMBA_RING, 2048)):
        case, q_pos, kv_pos = ring_case(torch, spans, ql, ring, torch.bfloat16, geo=geo,
                                        seed=5)
        scale = scale_of(geo)
        kw = dict(scale=scale, window=window, q_pos=q_pos, kv_pos_pages=kv_pos)
        layouts = {"": (case[1], False)}
        if geo == MLA:
            one, two = latent_planes(torch, case[1], LATENT_R[geo])
            layouts = {"": (one, True), "two_planes": (two, False)}
        for lname, (pages, v_from_k) in layouts.items():
            lcase = [case[0], pages, *case[2:]]
            n_bytes, flops, bound_ms, bound_by = ring_work(torch, lcase, q_pos, kv_pos,
                                                           window, "bfloat16")
            kernel = lambda: rpa(*lcase, max_q_len=max(ql), v_from_k=v_from_k,  # noqa: E731
                                 **kw)
            if geo == MLA:
                backend, lib = latent_sdpa(torch, lcase, q_pos, kv_pos, scale, window)
            else:
                backend, lib = None, ring_sdpa(torch, lcase, q_pos, kv_pos, scale, window)
            timing[name + (f"_{lname}" if lname else "")] = {
                "geometry": list(geo), "ring_slots": ring, "q_lens": ql, "window": window,
                "planes": 1 if v_from_k else pages.shape[2], "bytes": n_bytes,
                "flops": flops, "library_backend": backend,
                "ms": time_ms(torch, kernel, flush),
                "plain_ms": time_ms(torch, lambda: rpa_ref(*lcase, v_from_k=v_from_k, **kw),
                                    flush, iters=5, warmup=1),
                "library_ms": time_ms(torch, lib, flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "device_ms": device_ms(torch, kernel, flush,
                                       lambda key: "ragged_paged_attention" in key),
                "library_device_ms": device_ms(torch, lib, flush),
            }
    emit("kernel_time", kernel="ragged_paged_attention",
         mode="explicit positions: latent head, hymba", dtype="bfloat16", nvidia_smi=smi,
         shapes=timing)
    return max_err, timing


# ---------------------------------------------------------------------------
# SSD chunk scan at the mamba2-2.7b path's geometry
# ---------------------------------------------------------------------------


def ssd_case(torch, S, dtype, *, B=1, H=SSD_H, P=SSD_P, N=SSD_N, G=1,
             state=True, views=False, seed=0):
    """Inputs drawn as the model forms them: x, b, c ~ N(0, 1) in the model
    dtype, dt ~ U[1e-3, 1e-1] and A ~ U[1, 16) (the initialisers' ranges),
    and a random fp32 carried state (or None: zeros). ``views``: x, b and c
    are views into one (B, S, H*P + 2*G*N) tensor, as ``ssm_sublayer``
    hands over its conv output."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g)
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((B, S, H), generator=g)
    a = -(1.0 + 15.0 * torch.rand((H,), generator=g))
    b = torch.randn((B, S, G, N), generator=g)
    c = torch.randn((B, S, G, N), generator=g)
    init = torch.randn((B, H, P, N), generator=g) if state else None
    if views:
        xbc = torch.cat([t.reshape(B, S, -1) for t in (x, b, c)], -1).to(dtype).cuda()
        x = xbc[..., :H * P].reshape(B, S, H, P)
        b = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        c = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        assert not x.is_contiguous() and x.data_ptr() == xbc.data_ptr()
    return ([x.to(dtype).cuda(), dt.cuda(), a.cuda(), b.to(dtype).cuda(),
             c.to(dtype).cuda()], None if init is None else init.cuda())


def ssd_work(case, init, dtype_name, block=32):
    """(bytes, flops, bound_ms, bound_by) of the scan on this input: x, b,
    c, dt, a and the initial state read once, y and the final state written
    once; per (batch, head) and block of L tokens (32, fixed here whatever
    block the kernel walks, so the bound reads the same work across
    versions) the lower triangle of C.B^T (N*L*(L+1)) and of its product
    with x*dt (P*L*(L+1)), and the carried-state output and state update
    (2*L*P*N each)."""
    x, dt, a, b, c = case
    B, S, H, P = x.shape
    N = b.shape[3]
    item = x.element_size()
    n_bytes = (2 * x.numel() * item + (b.numel() + c.numel()) * item
               + 4 * (dt.numel() + a.numel() + B * H * P * N)
               + (0 if init is None else 4 * init.numel()))
    flops = 0
    for t0 in range(0, S, block):
        L = min(block, S - t0)
        flops += N * L * (L + 1) + P * L * (L + 1) + 4 * L * P * N
    flops *= B * H
    return (n_bytes, flops, *_bound(flops, n_bytes, dtype_name))


def ssd_kernel_phase(torch, sops, sref, smi):
    scan, plain = sops.ssd_scan, sref.ssd_scan_ref
    cases = [(f"S{S}_{'state' if st else 'zero'}", S, {"state": st})
             for S in (1, 9, 32) for st in (False, True)]
    cases += [("S512_multichunk", 512, {}),
              ("B2_G4_S40", 40, {"B": 2, "H": 8, "G": 4, "N": 64}),
              # the serving geometry as ssm_sublayer hands it over
              ("S32_projection_views", 32, {"views": True}),
              # hymba-1.5b: 50 heads in one group (two heads a cluster), N 16
              # (one k-step over the state); decode-length and page-length
              # chunks with a state, the 160-row first chunk from zeros
              ("hymba_S1_state", 1, SSD_HYMBA),
              ("hymba_S32_state", 32, SSD_HYMBA),
              ("hymba_S160_zero", 160, {**SSD_HYMBA, "state": False}),
              ("hymba_S32_projection_views", 32, {**SSD_HYMBA, "views": True})]
    errs, max_err = {}, {"float32": 0.0, "bfloat16": 0.0}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for i, (name, S, kw) in enumerate(cases):
            case, init = ssd_case(torch, S, dtype, seed=i, **kw)
            y, state = scan(*case, chunk=SSD_CHUNK, init_state=init)
            y2, state2 = scan(*case, chunk=SSD_CHUNK, init_state=init)
            want_y, want_state = plain(*case, chunk=SSD_CHUNK, init_state=init)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(state, state2)):
                raise AssertionError(f"ssd {dname}/{name}: two launches on "
                                     "the same input differ")
            err_y = (y.float() - want_y.float()).abs().max().item()
            err_s = (state - want_state).abs().max().item()
            errs[f"{dname}/{name}"] = {"y": err_y, "state": err_s}
            max_err[dname] = max(max_err[dname], err_y)
            if dname == "float32":
                ok_y = torch.allclose(y, want_y, atol=SSD_TOL, rtol=SSD_TOL)
            else:
                scale = want_y.float().abs().max().item()
                ok_y = torch.allclose(y.float(), want_y.float(), rtol=2 ** -6,
                                      atol=SSD_TOL * scale)
            ok_s = torch.allclose(state, want_state, atol=SSD_TOL, rtol=SSD_TOL)
            if not (ok_y and ok_s):
                raise AssertionError(f"ssd {dname}/{name}: kernel vs plain max "
                                     f"abs err y {err_y}, state {err_s}")
    emit("kernel_check", kernel="ssd_scan", max_abs_err=errs,
         tolerance={"float32": SSD_TOL, "bfloat16_y": "rtol 2**-6, atol "
                    f"{SSD_TOL} x max|y|", "state": SSD_TOL},
         launches_bit_equal=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for name, S, kw in (("S32", 32, {}), ("S9", 9, {}),
                        ("hymba_S32", 32, SSD_HYMBA),
                        ("hymba_S160", 160, {**SSD_HYMBA, "state": False})):
        case, init = ssd_case(torch, S, torch.bfloat16, seed=100 + S, **kw)
        n_bytes, flops, bound_ms, bound_by = ssd_work(case, init, "bfloat16")
        kernel = lambda: scan(*case, chunk=SSD_CHUNK, init_state=init)  # noqa: E731
        timing[name] = {
            "shape": [1, S, *case[0].shape[2:], case[3].shape[3]], "bytes": n_bytes,
            "flops": flops,
            "ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, lambda: plain(*case, chunk=SSD_CHUNK,
                                                     init_state=init),
                                flush, iters=20),
            "library_ms": None,   # no single PyTorch call computes an SSD scan
            "bound_ms": bound_ms, "bound_by": bound_by,
            # the card's time alone: events around a call of a few
            # microseconds include the host's launch gaps
            "device_ms": device_ms(torch, kernel, flush,
                                   lambda key: "ssd_scan" in key),
        }
    emit("kernel_time", kernel="ssd_scan", dtype="bfloat16", nvidia_smi=smi,
         shapes=timing)
    return max_err, timing


# ---------------------------------------------------------------------------
# The SSD scan's backward at the training path's geometry
# ---------------------------------------------------------------------------

SSD_BWD_GEOS = {"mamba2": {"H": SSD_H, "P": SSD_P, "N": SSD_N, "G": 1},
                "hymba": SSD_HYMBA}
# geometries no config has, for the bf16 gradients kernel's other layouts:
# N 256 (two column tasks a warp, G 2) and P 128 x N 128 (one state buffer)
SSD_BWD_EDGE = {"wide": {"H": 4, "P": 16, "N": 256, "G": 2},
                "tall": {"H": 4, "P": 128, "N": 128, "G": 1}}
SSD_BWD_SHAPES = {"mamba2": (4, 2048), "hymba": (2, HYMBA_META + 2048)}   # training
SSD_BWD_REL = 1e-4
# Each gradient g against the plain version's (same inputs, fp32 sums over
# 256-token chunks where the kernels walk 32-token blocks): |g - plain| <=
# rtol |plain| + atol, atol = max(1e-4 max|plain|, 4x the plain version's
# own error against itself in float64 on those inputs), rtol 2**-8 (one bf16
# rounding) for dx, db, dc in bf16 and 0 otherwise. bf16 runs take the fp32
# plain version on the same bf16 inputs.
SSD_BWD_NAMES = ("dx", "d_dt", "d_a", "db", "dc", "d_init")


def ssd_bwd_case(torch, B, S, dtype, *, geo, state, views, seed):
    """The scan's inputs as ``ssd_case`` draws them, and the cotangents dy
    ~ N(0, 1) in x's dtype and d_final ~ N(0, 1) fp32 (None with no
    state: the training path's)."""
    case, init = ssd_case(torch, S, dtype, B=B, state=state, views=views, seed=seed,
                          **geo)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(tuple(case[0].shape), generator=g).to(dtype).cuda()
    d_final = torch.randn(tuple(init.shape), generator=g).cuda() if state else None
    return case, init, dy, d_final


def ssd_bwd_work(case, init, d_final, block=32):
    """(bytes, flops, bound_ms, bound_by) of the backward on this input:
    x, dt, a, b, c, dy, the initial state and d_final read once, dx, d_dt,
    d_a, db, dc, d_init written once; per (batch, head) and 32-token block
    of L tokens M/Q/G over the lower triangle (L(L+1)/2 (N + P)), dxdt (P
    (L(L+1)/2 + L N)), dC and dB (N (L(L+1)/2 + L P) each) and the dState
    update (L P N), two flops an FMA at the peak rate of x's dtype (bf16
    products with fp32 sums run on the tensor cores, as the flash rows
    count them). The block-start states the kernels recompute are the
    design's own work, not the function's, and are not counted."""
    x, dt, a, b, c = case
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    item = x.element_size()
    state_bytes = 4 * B * H * P * N
    n_bytes = (3 * x.numel() * item + 2 * (b.numel() + c.numel()) * item
               + 4 * (2 * dt.numel() + 2 * a.numel()) + state_bytes
               + (0 if init is None else state_bytes)
               + (0 if d_final is None else state_bytes))
    fma = 0
    for t0 in range(0, S, block):
        L = min(block, S - t0)
        tri = L * (L + 1) // 2
        fma += (L * P * N + tri * (N + P) + P * (tri + L * N)
                + 2 * N * (tri + L * P))
    flops = 2 * fma * B * H
    return (n_bytes, flops, *_bound(flops, n_bytes, str(x.dtype).removeprefix("torch.")))


def ssd_bwd_kernel_phase(torch, sops, sref, smi):
    """The backward kernels (fp32: states, backward, reduce on FMAs; bf16:
    states, gradients, d(a) on the tensor cores) against the plain
    version ``ssd_scan_bwd_ref`` and against autograd through
    ``ssd_scan_ref``, both on the card, at mamba2-2.7b's and hymba-1.5b's
    geometries: S 256 with an initial state and a final-state cotangent, a
    ragged S 40 (B 2) without, and the training shape (4 x 2048, 2 x 2176)
    with x/b/c as views into one projection, and at ``SSD_BWD_EDGE``'s (B 2,
    ragged S 100, a state); fp32 and bf16; two launches bit-equal; times at
    the training shapes."""
    bwd, plain = sops.ssd_scan_bwd, sref.ssd_scan_bwd_ref
    cases = [(f"{geo}_{name}", geo, B, S, state, views)
             for geo in SSD_BWD_GEOS
             for name, B, S, state, views in (
                 ("S256_state", 1, 256, True, False),
                 ("B2_S40_zero", 2, 40, False, False),
                 (f"B{SSD_BWD_SHAPES[geo][0]}_S{SSD_BWD_SHAPES[geo][1]}_views",
                  *SSD_BWD_SHAPES[geo], False, True))]
    cases += [(f"{geo}_B2_S100_state", geo, 2, 100, True, False) for geo in SSD_BWD_EDGE]
    errs = {}
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for i, (name, geo, B, S, state, views) in enumerate(cases):
            case, init, dy, d_final = ssd_bwd_case(torch, B, S, dtype,
                                                   geo={**SSD_BWD_GEOS, **SSD_BWD_EDGE}[geo],
                                                   state=state, views=views, seed=40 + i)
            kw = dict(chunk=SSD_CHUNK, init_state=init, d_final=d_final)
            got = bwd(*case, dy, **kw)
            again = bwd(*case, dy, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"ssd bwd {dname}/{name}: two launches on the "
                                     "same input differ")
            del again
            ref = plain(*case, dy, **kw)
            f64 = plain(*(t.double() for t in case), dy.double(), chunk=SSD_CHUNK,
                        init_state=None if init is None else init.double(),
                        d_final=None if d_final is None else d_final.double())
            leaves = [t.detach().float().clone().requires_grad_() for t in case]
            init_leaf = None if init is None else init.clone().requires_grad_()
            y, final = sref.ssd_scan_ref(*leaves, chunk=SSD_CHUNK, init_state=init_leaf)
            outs, cots = [y], [dy.float()]
            if d_final is not None:
                outs.append(final)
                cots.append(d_final)
            auto = list(torch.autograd.grad(
                outs, leaves + ([init_leaf] if init_leaf is not None else []), cots))
            if init_leaf is None:
                auto.append(None)
            del leaves, init_leaf, y, final, outs
            case_err = {}
            for key, g, r, t, au in zip(SSD_BWD_NAMES, got, ref, f64, auto):
                r, t = r.float(), t.double()
                scale = r.abs().max().item()
                atol = max(SSD_BWD_REL * scale, 4 * (r.double() - t).abs().max().item())
                rtol = 2 ** -8 if g.dtype == torch.bfloat16 else 0.0
                err = (g.float() - r).abs().max().item()
                ok = bool(((g.float() - r).abs() <= rtol * r.abs() + atol).all())
                entry = {"vs_plain": err, "atol": atol, "rtol": rtol,
                         "kernel_vs_f64": (g.double() - t).abs().max().item(),
                         "plain_vs_f64": (r.double() - t).abs().max().item(),
                         "max_abs": scale}
                if au is not None:      # d_init exists only with an initial state
                    au = au.float()
                    entry["vs_autograd"] = (g.float() - au).abs().max().item()
                    ok = ok and bool(((g.float() - au).abs()
                                      <= rtol * au.abs() + atol).all())
                case_err[key] = entry
                max_err[dname] = max(max_err[dname], err)
                if not ok:
                    raise AssertionError(f"ssd bwd {dname}/{name}: {key} {entry}")
            errs[f"{dname}/{name}"] = case_err
            del case, init, dy, d_final, got, ref, f64, auto
    emit("kernel_check", kernel="ssd_scan_bwd", max_abs_err=errs,
         tolerance="|g - plain| <= rtol |plain| + atol, atol = max(1e-4 max|plain|, "
                   "4 x plain's error vs float64), rtol 2**-8 for bf16 dx/db/dc, 0 "
                   "otherwise; the same against autograd through ssd_scan_ref",
         launches_bit_equal=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for geo, (B, S) in SSD_BWD_SHAPES.items():
        case, init, dy, d_final = ssd_bwd_case(torch, B, S, torch.bfloat16,
                                               geo=SSD_BWD_GEOS[geo], state=False,
                                               views=True, seed=90)
        n_bytes, flops, bound_ms, bound_by = ssd_bwd_work(case, init, d_final)
        x = case[0]
        P, N = x.shape[3], case[3].shape[3]
        nb = -(-S // sops.BLOCK)
        kernel = lambda: bwd(*case, dy, chunk=SSD_CHUNK)  # noqa: E731
        timing[geo] = {
            "shape": [B, S, x.shape[2], P, N], "bytes": n_bytes, "flops": flops,
            "ms": time_ms(torch, kernel, flush, iters=10, warmup=2),
            "plain_ms": time_ms(torch, lambda: plain(*case, dy, chunk=SSD_CHUNK), flush,
                                iters=3, warmup=1),
            "library_ms": None,   # no single PyTorch call computes an SSD backward
            "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": device_ms(torch, kernel, flush, lambda key: "ssd_bwd_" in key),
            # the three launches apart: S0 and dS, the per-block gradients,
            # the sum of d(a)'s partials
            "states_device_ms": device_ms(torch, kernel, flush,
                                          lambda key: "ssd_bwd_states" in key),
            "grads_device_ms": device_ms(torch, kernel, flush,
                                         lambda key: "ssd_bwd_grads" in key),
            "da_device_ms": device_ms(torch, kernel, flush,
                                      lambda key: "ssd_bwd_da" in key),
            "forward_device_ms": device_ms(
                torch, lambda: sops.ssd_scan(*case, chunk=SSD_CHUNK), flush,
                lambda key: "ssd_scan_mma" in key),
            # the block-start states and their cotangents, written and read
            # once; no per-head dB/dC partials in bf16
            "states_bytes": 2 * 4 * B * nb * x.shape[2] * P * N,
            "partials_bytes": 0,
            "smem_bytes": sops.bwd_smem_bytes(P, N, torch.bfloat16)}
        timing[geo]["bound_share"] = timing[geo]["bound_ms"] / timing[geo]["device_ms"]
        del case, dy
    emit("kernel_time", kernel="ssd_scan_bwd", dtype="bfloat16", nvidia_smi=smi,
         shapes=timing)
    return max_err, timing


# ---------------------------------------------------------------------------
# Flash attention at the training path's geometry
# ---------------------------------------------------------------------------

MLA_TRAIN = (4, 2048, 16, 16, 192, 128)   # deepseek-v2-lite-16b's un-absorbed MLA
# training: B, S, 16 query heads on 16 KV heads, Dk = dn + dr = 128 + 64, Dv 128
FA_CASES = [  # name, B, S, H, Hkv, Dk, Dv, cap, window
    ("gemma2b", 4, 2048, 8, 1, 256, 256, None, None),
    ("qwen3_8b", 1, 2048, 32, 8, 128, 128, None, None),
    ("cap50_window64", 2, 1024, 8, 1, 256, 256, 50.0, 64),
    ("ragged_S1000", 2, 1000, 8, 1, 256, 256, None, None),
    ("d64_gqa4_S300", 2, 300, 8, 2, 64, 64, None, None),
    ("d32_mha_cap30", 2, 300, 4, 4, 32, 32, 30.0, None),
    ("S17", 2, 17, 8, 1, 256, 256, None, None),
    ("d64_S17_window5", 1, 17, 8, 1, 64, 64, None, 5),
    ("d128_G3_S200", 2, 200, 6, 2, 128, 128, None, None),   # G does not divide 64
    # gemma2-27b's ring prefill: 32/16 heads, softcap 50, its 4096 window binding
    ("gemma2_27b_S4400_window4096", 1, 4400, 32, 16, 128, 128, 50.0, 4096),
    # hymba-1.5b's ring first chunk: 128 meta tokens + 32, 25/5 heads at D 64
    ("hymba_ring_first_chunk", 1, 160, 25, 5, 64, 64, None, 2048),
    # hymba-1.5b's training: 128 meta tokens + 2048, its window of 2048 binding
    ("hymba_train", 2, HYMBA_META + 2048, 25, 5, 64, 64, None, 2048),
    # Dk 192 != Dv 128: deepseek-v2-lite's training shape, ragged S 1000 and
    # S 17 (below a tile), and beside them the general mask paths (softcap +
    # window) and G = 3 (rows by cp.async), which MLA itself does not take
    ("mla_train", *MLA_TRAIN, None, None),
    ("mla_ragged_S1000", 2, 1000, 16, 16, 192, 128, None, None),
    ("mla_S17", 2, 17, 16, 16, 192, 128, None, None),
    ("dk192_dv128_cap30_window64", 1, 300, 4, 4, 192, 128, 30.0, 64),
    ("dk192_dv128_G3_S200", 1, 200, 6, 2, 192, 128, None, None),
    # G S = 4500 rows > DKDV_UNIT_ROWS: the bf16 dK/dV kernel cuts the first
    # 22 key tiles at (192, 128) and sums their slot partials
    ("dk192_dv128_G3_S1500", 1, 1500, 6, 2, 192, 128, None, None),
    # musicgen-large's training: MHA 32/32 at D 64, a group of 1
    ("musicgen_train", 4, 2048, *MUSICGEN, MUSICGEN[-1], None, None),
]
# the training shapes timed: B, S, H, Hkv, Dk, Dv, window, seed
TRAIN_SHAPES = {"hymba_train": (2, HYMBA_META + 2048, *HYMBA, HYMBA[-1], 2048, 10),
                "mla_train": (*MLA_TRAIN, None, 11),
                "musicgen_train": (4, 2048, *MUSICGEN, MUSICGEN[-1], None, 12)}
# the redesigned bf16 kernels: wgmma (HGMMA) in the flash kernels, mma.sync
# (HMMA) in paged attention and the SSD scan and its backward
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")
SSD_BWD_MMA_KERNELS = ("ssd_bwd_states_mma_kernel", "ssd_bwd_grads_mma_kernel")
MMA_KERNELS = ("ragged_paged_attention_mma_kernel", "ragged_paged_attention_latent_kernel",
               "ssd_scan_mma_kernel", *SSD_BWD_MMA_KERNELS)
FA_TOL = {"float32": {"values": 3e-5, "grads": 2e-4}, "bfloat16": 2e-2}
# fp32: the reference's own flash tolerances — values 3e-5 atol and rtol
# (tests/test_kernels.py), gradients 2e-4 (tests/test_models.py); sums run
# in another order. bf16: 2e-2 of the largest |value| (the reference's bf16
# flash tolerance, taken relative: gradients summed over 2048 rows grow
# well past 1, and each side rounds its own fp32 result to bf16).


def flash_case(torch, B, S, H, Hkv, D, dtype, seed=0, Dv=None):
    """q, k (head dim D), v and the output cotangent dO (head dim Dv,
    default D), ~N(0, 1), on the card."""
    Dv = Dv or D
    g = torch.Generator().manual_seed(seed)
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv), (B, S, H, Dv)]
    return [torch.randn(s, generator=g).to(dtype).cuda() for s in shapes]


def split_tile_check(torch, fops, fref):
    """The bf16 dK/dV kernel's cut key tiles at (192, 128), which the MLA
    training shapes (a group of 1, S <= 2048) never reach under
    DKDV_UNIT_ROWS: mla_ragged_S1000 with every key tile cut at 64 rows
    (its slot partials summed by the reduce launch), against the plain
    version at the bf16 tolerance, two launches bit-equal. Also requires
    that dk192_dv128_G3_S1500 cuts tiles at the default unit, so the
    FA_CASES loop holds that path too."""
    _, B, S, H, Hkv, D, Dv, _, _ = next(c for c in FA_CASES if c[0] == "mla_ragged_S1000")
    _, _, S2, H2, Hkv2, _, _, _, _ = next(c for c in FA_CASES
                                          if c[0] == "dk192_dv128_G3_S1500")
    default_slots = sum(u[3] >= 0 for u in fops.dkdv_plan(S2, S2, H2 // Hkv2))
    if not default_slots:
        raise AssertionError("dk192_dv128_G3_S1500 cuts no key tile")
    unit_rows = 64
    slots = sum(u[3] >= 0 for u in fops.dkdv_plan(S, S, H // Hkv, None, unit_rows))
    q, k, v, do = flash_case(torch, B, S, H, Hkv, D, torch.bfloat16, seed=3, Dv=Dv)
    scale = D ** -0.5
    out, m, l = fops.flash_attention_fwd(q, k, v, scale=scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, m, l, do, delta, scale, None, None)
    got = fops._dkdv_launch(*args, unit_rows=unit_rows)
    again = fops._dkdv_launch(*args, unit_rows=unit_rows)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("flash split tiles: two launches on the same input differ")
    plain = fref.flash_bwd_ref(q, k, v, m, l, do, delta, scale=scale)[1:]
    res = {"case": "mla_ragged_S1000", "unit_rows": unit_rows, "slots": slots,
           "dk192_dv128_G3_S1500_default_slots": default_slots}
    for key, a, b in zip(("dk", "dv"), got, plain):
        err = (a.float() - b.float()).abs().max().item()
        rel = err / b.float().abs().max().item()
        res[key] = {"abs": err, "relative": rel}
        if not rel <= FA_TOL["bfloat16"]:
            raise AssertionError(f"flash split tiles: {key} vs plain error {res[key]}")
    return res


def flash_work(B, S, H, Hkv, D, item, Dv=None):
    """(flops, bytes) of each kernel's function on these causal shapes:
    every input read once, every output written once; per visible (query,
    key) pair (S(S+1)/2 per head) and head, 2 flops per product dim of
    each matrix product — Dk for QKᵀ, dSᵀ Q and dS K, Dv (default Dk) for
    PV, dO Vᵀ and Pᵀ dO: the forward does QKᵀ and PV, the dK/dV kernel
    QKᵀ, dO Vᵀ, Pᵀ dO and dSᵀ Q, the dQ kernel QKᵀ, dO Vᵀ and dS K."""
    Dv = Dv or D
    pairs = S * (S + 1) // 2 * B * H
    qk, qv = B * S * H * D * item, B * S * H * Dv * item       # q / dq; out / dO
    kk, kv = B * S * Hkv * D * item, B * S * Hkv * Dv * item   # k / dk; v / dv
    stats = B * H * S * 4
    return {"flash_attention_fwd": (2 * (D + Dv) * pairs, qk + qv + kk + kv + 2 * stats),
            "flash_attention_bwd_dkdv": (4 * (D + Dv) * pairs,
                                         qk + qv + 2 * kk + 2 * kv + 3 * stats),
            "flash_attention_bwd_dq": (2 * (2 * D + Dv) * pairs,
                                       2 * qk + qv + kk + kv + 3 * stats)}


def _bound(flops, n_bytes, dtype_name):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_kernel_phase(torch, fops, fref, smi):
    """The forward and both backward kernels against their plain versions
    (``flash_fwd_ref``/``flash_bwd_ref``) and against autograd through the
    naive oracle ``attention_ref``; repeat launches bit-equal; times."""
    errs = {}
    max_err = {k: {"float32": 0.0, "bfloat16": 0.0}
               for k in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                         "flash_attention_bwd_dq")}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, B, S, H, Hkv, D, Dv, cap, window in FA_CASES:
            q, k, v, do = flash_case(torch, B, S, H, Hkv, D, dtype, Dv=Dv)
            kw = dict(scale=D ** -0.5, cap=cap, window=window)
            out, m, l = fops.flash_attention_fwd(q, k, v, **kw)
            grads = fops.flash_attention_bwd(q, k, v, out, m, l, do, **kw)
            out2, m2, l2 = fops.flash_attention_fwd(q, k, v, **kw)
            grads2 = fops.flash_attention_bwd(q, k, v, out, m, l, do, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       zip((out, m, l, *grads), (out2, m2, l2, *grads2))):
                raise AssertionError(f"flash {dname}/{name}: two launches on "
                                     "the same input differ")
            want, wm, wl = fref.flash_fwd_ref(q, k, v, **kw)
            delta = (do.float() * want.float()).sum(-1).transpose(1, 2).contiguous()
            plain = fref.flash_bwd_ref(q, k, v, wm, wl, do, delta, **kw)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            naive = fref.attention_ref(*leaves, **kw)
            auto = torch.autograd.grad(naive, leaves, do)
            naive = naive.detach()
            del leaves
            got = {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
            refs = {"plain": {"out": want, "dq": plain[0], "dk": plain[1], "dv": plain[2]},
                    "autograd": {"out": naive, "dq": auto[0], "dk": auto[1], "dv": auto[2]}}
            case_err = {}
            for oracle, ref in refs.items():
                for key, a in got.items():
                    b = ref[key].float()
                    err = (a.float() - b).abs().max().item()
                    if dname == "float32":
                        tol = FA_TOL[dname]["values" if key == "out" else "grads"]
                        ok = torch.allclose(a, b, atol=tol, rtol=tol)
                        case_err[f"{oracle}/{key}"] = err
                    else:
                        rel = err / b.abs().max().item()
                        ok = rel <= FA_TOL[dname]
                        case_err[f"{oracle}/{key}"] = {"abs": err, "relative": rel}
                    if not ok:
                        raise AssertionError(f"flash {dname}/{name}: {key} vs "
                                             f"{oracle} error {case_err[f'{oracle}/{key}']}")
                    kern = {"out": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                            "dk": "flash_attention_bwd_dkdv",
                            "dv": "flash_attention_bwd_dkdv"}[key]
                    if oracle == "plain":
                        max_err[kern][dname] = max(max_err[kern][dname], err)
            errs[f"{dname}/{name}"] = case_err
            del q, k, v, do, out, m, l, grads, out2, m2, l2, grads2, want, plain, auto
    split = errs["bfloat16/split_tiles"] = split_tile_check(torch, fops, fref)
    max_err["flash_attention_bwd_dkdv"]["bfloat16"] = max(
        max_err["flash_attention_bwd_dkdv"]["bfloat16"], split["dk"]["abs"], split["dv"]["abs"])
    emit("kernel_check", kernel="flash_attention", max_abs_err=errs,
         tolerance={"float32": FA_TOL["float32"],
                    "bfloat16": "2e-2 of the largest |value|"},
         launches_bit_equal=True)

    # -- times at the gemma-2b training shape, bf16 ----------------------
    _, B, S, H, Hkv, D, _, _, _ = FA_CASES[0]
    q, k, v, do = flash_case(torch, B, S, H, Hkv, D, torch.bfloat16, seed=7)
    scale = D ** -0.5
    out, m, l = fops.flash_attention_fwd(q, k, v, scale=scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bwd_args = (q, k, v, m, l, do, delta)
    plain_bwd_ms = time_ms(torch, lambda: fref.flash_bwd_ref(*bwd_args, scale=scale),
                           flush, iters=5, warmup=1)
    timing = {
        "flash_attention_fwd": {
            "ms": time_ms(torch, lambda: fops.flash_attention_fwd(q, k, v, scale=scale), flush),
            "plain_ms": time_ms(torch, lambda: fref.flash_fwd_ref(q, k, v, scale=scale),
                                flush, iters=5, warmup=1)},
        "flash_attention_bwd_dkdv": {
            "ms": time_ms(torch, lambda: fops.flash_attention_bwd_dkdv(*bwd_args, scale=scale),
                          flush),
            "plain_ms": plain_bwd_ms},
        "flash_attention_bwd_dq": {
            "ms": time_ms(torch, lambda: fops.flash_attention_bwd_dq(*bwd_args, scale=scale),
                          flush),
            "plain_ms": plain_bwd_ms},
    }
    for name, (flops, n_bytes) in flash_work(B, S, H, Hkv, D, 2).items():
        bound_ms, bound_by = _bound(flops, n_bytes, "bfloat16")
        timing[name].update(flops=flops, bytes=n_bytes, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
    # the yardstick, never called by the port: one SDPA call (B, H, S, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    leaves = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]

    def lib_fwd():
        return sdpa(qs, ks, vs, is_causal=True, scale=scale, enable_gqa=True)

    def lib_fwd_bwd():
        o = sdpa(*leaves, is_causal=True, scale=scale, enable_gqa=True)
        return torch.autograd.grad(o, leaves, dos)

    from torch.profiler import ProfilerActivity, profile
    backends = {}
    for name, fn in (("forward", lib_fwd), ("forward_backward", lib_fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        backends[name] = sorted({e.key[:90] for e in prof.key_averages()
                                 if e.self_device_time_total > 0})
    timing["flash_attention_fwd"]["library_ms"] = time_ms(torch, lib_fwd, flush)
    sdpa_fwd_bwd_ms = time_ms(torch, lib_fwd_bwd, flush, iters=20)
    # the dK/dV kernel without its row split: one unit per key tile
    no_split_ms = time_ms(torch, lambda: fops._dkdv_launch(*bwd_args, scale, None, None,
                                                           unit_rows=None), flush)
    # the ring path's first chunk at gemma2-27b (32/16 heads at D 128,
    # softcap 50, window 4096, its longest first chunk: 2048 rows); SDPA has
    # no softcap and is timed causal on the same inputs
    B2, S2, H2, Hkv2, D2 = 1, 2048, *GEMMA2
    q2, k2, v2, _ = flash_case(torch, B2, S2, H2, Hkv2, D2, torch.bfloat16, seed=8)
    kw2 = dict(scale=scale_of(GEMMA2), cap=GEMMA2_CAP, window=GEMMA2_WINDOW)
    flops2, bytes2 = flash_work(B2, S2, H2, Hkv2, D2, 2)["flash_attention_fwd"]
    qs2, ks2, vs2 = (t.transpose(1, 2).contiguous() for t in (q2, k2, v2))
    gemma2 = {
        "shape": [B2, S2, H2, Hkv2, D2], "cap": GEMMA2_CAP, "window": GEMMA2_WINDOW,
        "flops": flops2, "bytes": bytes2,
        "ms": time_ms(torch, lambda: fops.flash_attention_fwd(q2, k2, v2, **kw2), flush),
        "plain_ms": time_ms(torch, lambda: fref.flash_fwd_ref(q2, k2, v2, **kw2), flush,
                            iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: sdpa(qs2, ks2, vs2, is_causal=True,
                                                  scale=kw2["scale"], enable_gqa=True),
                              flush)}
    gemma2["bound_ms"], gemma2["bound_by"] = _bound(flops2, bytes2, "bfloat16")
    timing["flash_attention_fwd"]["gemma2_27b_prefill"] = gemma2
    # hymba-1.5b's ring first chunk: 128 meta tokens + 32 rows, 25/5 heads at
    # D 64 under its window of 2048 (which 160 rows never reach)
    B3, S3, H3, Hkv3, D3 = 1, HYMBA_META + PAGE, *HYMBA
    q3, k3, v3, _ = flash_case(torch, B3, S3, H3, Hkv3, D3, torch.bfloat16, seed=9)
    kw3 = dict(scale=D3 ** -0.5, window=2048)
    flops3, bytes3 = flash_work(B3, S3, H3, Hkv3, D3, 2)["flash_attention_fwd"]
    qs3, ks3, vs3 = (t.transpose(1, 2).contiguous() for t in (q3, k3, v3))
    hymba = {
        "shape": [B3, S3, H3, Hkv3, D3], "window": 2048, "flops": flops3, "bytes": bytes3,
        "ms": time_ms(torch, lambda: fops.flash_attention_fwd(q3, k3, v3, **kw3), flush),
        "plain_ms": time_ms(torch, lambda: fref.flash_fwd_ref(q3, k3, v3, **kw3), flush,
                            iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: sdpa(qs3, ks3, vs3, is_causal=True,
                                                  scale=kw3["scale"], enable_gqa=True),
                              flush)}
    hymba["bound_ms"], hymba["bound_by"] = _bound(flops3, bytes3, "bfloat16")
    timing["flash_attention_fwd"]["hymba_ring_first_chunk"] = hymba
    # the training paths' shapes; the bounds count the causal pairs (hymba's
    # window of 2048 drops ~1.3% of them)
    train_sdpa = {}
    for shape, args in TRAIN_SHAPES.items():
        res = train_shape_times(torch, fops, fref, flush, *args)
        train_sdpa[shape] = res.pop("sdpa")
        for name, t in res.items():
            timing[name][shape] = t
    for t in (*timing.values(), gemma2, hymba,
              *(by_shape[shape] for by_shape in timing.values() for shape in TRAIN_SHAPES)):
        t["tflops"] = t["flops"] / t["ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
    sdpa_fwd_ms = timing["flash_attention_fwd"]["library_ms"]
    emit("kernel_time", kernel="flash_attention", dtype="bfloat16",
         shape=[B, S, H, Hkv, D], causal=True, nvidia_smi=smi, kernels=timing,
         train_sdpa=train_sdpa,
         sdpa_forward_ms=sdpa_fwd_ms, sdpa_forward_backward_ms=sdpa_fwd_bwd_ms,
         sdpa_backward_ms=sdpa_fwd_bwd_ms - sdpa_fwd_ms, sdpa_device_kernels=backends,
         flash_backward_both_ms=timing["flash_attention_bwd_dkdv"]["ms"]
         + timing["flash_attention_bwd_dq"]["ms"],
         dkdv_unit_rows=fops.DKDV_UNIT_ROWS, dkdv_no_split_ms=no_split_ms)
    emit("kernel_accuracy", kernel="flash_attention", shape=[B, S, H, Hkv, D],
         **bf16_vs_float64(torch, fops, fref, q, k, v, do, scale))
    return max_err, timing


def train_shape_times(torch, fops, fref, flush, B, S, H, Hkv, Dk, Dv, window, seed,
                      rounds=5):
    """The three kernels at a training shape (bf16, causal, scale Dk^-1/2,
    ``window`` where given), timed by CUDA events in ``rounds`` rounds that
    alternate them with the first ``scaled_dot_product_attention`` backend
    that takes the inputs (forward, and forward + backward: its backward is
    not split by kernel; it has no window, so it runs causal): each time is
    the median of the rounds' medians, with their range beside it. The
    plain versions are timed once; the SM clock is read before and after."""
    q, k, v, do = flash_case(torch, B, S, H, Hkv, Dk, torch.bfloat16, seed=seed, Dv=Dv)
    kw = dict(scale=Dk ** -0.5, window=window)
    out, m, l = fops.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, m, l, do, delta)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = dict(is_causal=True, scale=kw["scale"], enable_gqa=H != Hkv)
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    leaves = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]
    fwd_backend, lib_fwd = sdpa_backend(torch, lambda: sdpa(qs, ks, vs, **lib))

    def fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves, **lib), leaves, dos)

    bwd_backend, lib_fwd_bwd = sdpa_backend(torch, fwd_bwd)
    calls = {"flash_attention_fwd": (lambda: fops.flash_attention_fwd(q, k, v, **kw), 20),
             "flash_attention_bwd_dkdv":
                 (lambda: fops.flash_attention_bwd_dkdv(*bwd, **kw), 20),
             "flash_attention_bwd_dq": (lambda: fops.flash_attention_bwd_dq(*bwd, **kw), 20),
             "sdpa_forward": (lib_fwd, 20), "sdpa_forward_backward": (lib_fwd_bwd, 10)}
    clocks = [sm_clock()]
    runs = {name: [] for name in calls}
    for _ in range(rounds):
        for name, (fn, iters) in calls.items():
            runs[name].append(time_ms(torch, fn, flush, iters=iters, warmup=2))
    clocks.append(sm_clock())
    med = {name: statistics.median(r) for name, r in runs.items()}
    plain_bwd = time_ms(torch, lambda: fref.flash_bwd_ref(*bwd, **kw), flush, iters=3,
                        warmup=1)
    plain_fwd = time_ms(torch, lambda: fref.flash_fwd_ref(q, k, v, **kw), flush, iters=3,
                        warmup=1)
    res = {}
    for name, (flops, n_bytes) in flash_work(B, S, H, Hkv, Dk, 2, Dv=Dv).items():
        t = res[name] = {"shape": [B, S, H, Hkv, Dk, Dv], "window": window,
                         "flops": flops, "bytes": n_bytes, "ms": med[name],
                         "ms_range": [min(runs[name]), max(runs[name])],
                         "rounds": rounds,
                         "plain_ms": plain_fwd if name == "flash_attention_fwd" else plain_bwd,
                         "library_ms": None}
        t["bound_ms"], t["bound_by"] = _bound(flops, n_bytes, "bfloat16")
    res["flash_attention_fwd"].update(library_ms=med["sdpa_forward"],
                                      library_backend=fwd_backend)
    # dK/dV alone has no library call: beside it, SDPA's whole backward (dQ,
    # dK and dV; causal, no window)
    res["flash_attention_bwd_dkdv"].update(
        library_ms=med["sdpa_forward_backward"] - med["sdpa_forward"],
        library_backend=f"{bwd_backend} backward")
    res["sdpa"] = {
        "forward_ms": med["sdpa_forward"], "forward_range": [min(runs["sdpa_forward"]),
                                                              max(runs["sdpa_forward"])],
        "forward_backend": fwd_backend,
        "forward_backward_ms": med["sdpa_forward_backward"],
        "forward_backward_range": [min(runs["sdpa_forward_backward"]),
                                   max(runs["sdpa_forward_backward"])],
        "forward_backward_backend": bwd_backend,
        "backward_ms": med["sdpa_forward_backward"] - med["sdpa_forward"],
        "sm_clock_mhz_before_after": clocks}
    return res


def sm_clock():
    """The card's SM clock in MHz, as ``nvidia-smi`` reads it now."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(res.stdout.strip().splitlines()[0])


def bf16_vs_float64(torch, fops, fref, q, k, v, do, scale):
    """Recorded, not held: the bf16 kernels and the bf16 plain versions,
    each against the plain versions in float64 on the same (bf16) inputs —
    out, dQ, dK, dV as the largest error over the largest |value|. The
    tensor-core kernels round P (and dS) to bf16 before their products; the
    plain versions round P before P.V only."""
    def run_kernels():
        out, m, l = fops.flash_attention_fwd(q, k, v, scale=scale)
        return (out, *fops.flash_attention_bwd(q, k, v, out, m, l, do, scale=scale))

    def run_plain(*x):
        out, m, l = fref.flash_fwd_ref(*x[:3], scale=scale)
        delta = (x[3].to(torch.promote_types(out.dtype, torch.float32)) * out).sum(-1)
        delta = delta.transpose(1, 2).contiguous()
        return (out, *fref.flash_bwd_ref(*x[:3], m, l, x[3], delta, scale=scale))

    truth = run_plain(*(t.double() for t in (q, k, v, do)))
    res = {}
    for name, got in (("kernels", run_kernels()), ("plain", run_plain(q, k, v, do))):
        res[f"{name}_vs_float64"] = {
            key: float((a.double() - b).abs().max() / b.abs().max())
            for key, a, b in zip(("out", "dq", "dk", "dv"), got, truth)}
    return res


def reduced_model_phase(torch, cfg_mod, tfm, param):
    """The model's paged steps on a reduced fp32 qwen3-8b: CUDA (the
    kernel) against the CPU path (the plain version), same weights."""
    cfg = cfg_mod.reduced(cfg_mod.get_config("qwen3-8b"), dtype="float32",
                          param_dtype="float32", head_dim=128, n_heads=8,
                          n_kv_heads=2, d_model=256)
    params = tfm.init_params(cfg, 0, device="cuda")
    outs = {}
    for dev in ("cuda", "cpu"):
        p = param.tree_map(lambda a: a.to(dev), params)
        caches = tfm.init_paged_caches(cfg, 8, PAGE, torch.float32, device=dev)
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(2, cfg.vocab_size, (1, 45), generator=g).to(dev)
        ext = torch.randint(2, cfg.vocab_size, (1, 9), generator=g).to(dev)
        last = torch.randint(2, cfg.vocab_size, (2, 1), generator=g).to(dev)
        tbl = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32, device=dev)
        tbl2 = torch.tensor([[1, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32,
                            device=dev)
        res = []
        lg, caches = tfm.paged_prefill(cfg, p, {"tokens": toks}, caches, tbl)
        res.append(lg)
        lg, caches = tfm.paged_extend(cfg, p, caches, ext, 45, tbl)
        res.append(lg)
        lg, caches = tfm.paged_decode(cfg, p, caches, last,
                                      torch.tensor([54, 0], device=dev), tbl2,
                                      active=torch.tensor([True, False], device=dev))
        res.append(lg[:1])
        outs[dev] = [r.float().cpu() for r in res]
    errs = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        errs.append(rel)
        if not rel < 1e-4:
            raise AssertionError(f"reduced model on CUDA vs CPU: relative "
                                 f"logit error {rel}")
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on CUDA")
    emit("reduced_model_check", arch="qwen3-8b", relative_logit_err=errs,
         tolerance=1e-4)


def init_device_phase(torch, cfg_mod, tfm, param):
    """The port's copy of JAX's generator draws the same bits on the card
    as on the CPU, where tests/test_torch_jax_random.py holds them equal
    to jax.random's: reduced qwen3-8b, mamba2-2.7b, gemma-2b, hymba-1.5b,
    deepseek-v2-lite-16b, mixtral-8x22b, musicgen-large and internvl2-76b
    at seed 3, every leaf bit for bit (the SSM initialisers' float32 log and
    expm1 and hymba's meta tokens included). The launchers draw their
    weights on the card."""
    unequal, total = {}, {}
    for arch in ("qwen3-8b", "mamba2-2.7b", "gemma-2b", "hymba-1.5b",
                 "deepseek-v2-lite-16b", "mixtral-8x22b", "musicgen-large",
                 "internvl2-76b"):
        cfg = cfg_mod.reduced(cfg_mod.get_config(arch))
        on_card = param.tree_leaves(tfm.init_params(cfg, 3, device="cuda"))
        on_cpu = param.tree_leaves(tfm.init_params(cfg, 3, device="cpu"))
        bits = {2: torch.int16, 4: torch.int32}
        unequal[arch] = sum(
            int((a.cpu().reshape(-1).view(bits[a.element_size()])
                 != b.reshape(-1).view(bits[b.element_size()])).sum())
            for a, b in zip(on_card, on_cpu))
        total[arch] = sum(b.numel() for b in on_cpu)
    emit("init_device_check", unequal_elements=unequal, elements=total)
    _require("init_device_check", {arch: n == 0 for arch, n in unequal.items()})


def reduced_ssm_phase(torch, cfg_mod, tfm, param, serve):
    """Reduced fp32 mamba2-2.7b: paged prefill (page 0), extend (page 1) and
    a batched decode with an inactive row, CUDA (the SSD kernel) against
    the CPU path, same weights; then, on CUDA, in fp32 (the FMA kernel) and
    in bf16 (the tensor-core kernel), an engine whose prefix hits resume
    from state pages decodes the tokens of a cold start."""
    full = cfg_mod.get_config("mamba2-2.7b")
    cfg = cfg_mod.reduced(full, dtype="float32", param_dtype="float32")
    params = tfm.init_params(cfg, 0, device="cuda")
    outs = {}
    for dev in ("cuda", "cpu"):
        p = param.tree_map(lambda a: a.to(dev), params)
        caches = tfm.init_paged_caches(cfg, 8, PAGE, torch.float32, device=dev)
        g = torch.Generator().manual_seed(2)
        toks = torch.randint(2, cfg.vocab_size, (1, PAGE), generator=g).to(dev)
        ext = torch.randint(2, cfg.vocab_size, (1, 9), generator=g).to(dev)
        last = torch.randint(2, cfg.vocab_size, (2, 1), generator=g).to(dev)
        tbl = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32, device=dev)
        tbl2 = torch.tensor([[1, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32,
                            device=dev)
        res = []
        lg, caches = tfm.paged_prefill(cfg, p, {"tokens": toks}, caches, tbl,
                                       page_tokens=PAGE)
        res.append(lg)
        lg, caches = tfm.paged_extend(cfg, p, caches, ext, PAGE, tbl,
                                      page_tokens=PAGE)
        res.append(lg)
        lg, caches = tfm.paged_decode(cfg, p, caches, last,
                                      torch.tensor([PAGE + 9, 0], device=dev),
                                      tbl2, page_tokens=PAGE,
                                      active=torch.tensor([True, False], device=dev))
        res.append(lg[:1])
        outs[dev] = [r.float().cpu() for r in res]
    errs = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        errs.append(rel)
        if not rel < 1e-4:
            raise AssertionError(f"reduced mamba2 on CUDA vs CPU: relative "
                                 f"logit error {rel}")
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on CUDA")

    cfg16 = cfg_mod.reduced(full)                     # bf16
    hits, skipped = {}, {}
    for dname, c, w in (("float32", cfg, params),
                        ("bfloat16", cfg16, tfm.init_params(cfg16, 0, device="cuda"))):
        same, hits[dname], skipped[dname] = engine_hit_equals_cold(
            serve, "mamba2-2.7b", c, full, w, [])
        if not same or hits[dname] < 1:
            raise AssertionError(f"reduced mamba2 on CUDA, {dname}: prefix hit "
                                 f"({hits[dname]} hits) does not decode the "
                                 "cold-start tokens")
    emit("reduced_model_check", arch="mamba2-2.7b", relative_logit_err=errs,
         tolerance=1e-4, hit_equals_cold={"float32": True, "bfloat16": True},
         compute_hits=hits, prefill_tokens_skipped=skipped)


def engine_hit_equals_cold(serve, arch, c, full, params, flags, n=4,
                           max_new=6):
    """On CUDA, ``arch``'s engine with ``launch/serve.py``'s defaults and
    ``flags``: the first of ``n`` prompts behind a shared 32-token head
    alone (publishing the head), then the rest; with prefix caching and
    without. Returns (tokens equal, compute hits, skipped tokens)."""
    runs = {}
    for name, extra in (("hit", []), ("cold", ["--no-prefix-caching"])):
        args = serve.parser().parse_args(["--arch", arch, *flags, *extra])
        eng = serve.build_engine(args, c, full, params, device="cuda")
        eng.ecfg.eos_token = -1
        prompts = serve.make_prompts(c, n, 32, args.seed)
        eng.submit(prompts[0], max_new_tokens=max_new)
        eng.run_until_idle()
        for pr in prompts[1:]:
            eng.submit(pr, max_new_tokens=max_new)
        rep = eng.run_until_idle()
        runs[name] = ({k: list(v) for k, v in eng.outputs.items()}, rep)
    rep = runs["hit"][1]
    return (runs["hit"][0] == runs["cold"][0], rep["prefix"]["compute_hits"],
            rep["prefill_tokens_skipped"])


def reduced_ring_phase(torch, cfg_mod, tfm, param, serve):
    """The ring path on a reduced fp32 gemma2-27b (group 2 at D 128, the
    window of 64 on alternate layers, softcap 50): prefill 40 tokens into
    rings of 96 (local: 64), extend 30 (the local rings wrap), one decode
    round with row 1 inactive — CUDA (the flash forward and the position
    mode) against the CPU (the plain versions), same weights; and a reduced
    fp32 qwen3-8b's ring and paged engines on CUDA decode the same tokens,
    the ring hit copying a snapshot, the paged one nothing."""
    cfg = cfg_mod.reduced(cfg_mod.get_config("gemma2-27b"), dtype="float32",
                          param_dtype="float32", head_dim=128, n_heads=8,
                          n_kv_heads=4, d_model=256)
    params = tfm.init_params(cfg, 0, device="cuda")
    outs, rings = {}, {}
    for dev in ("cuda", "cpu"):
        p = param.tree_map(lambda a: a.to(dev), params)
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(2, cfg.vocab_size, (2, 40), generator=g).to(dev)
        ext = torch.randint(2, cfg.vocab_size, (2, 30), generator=g).to(dev)
        last = torch.randint(2, cfg.vocab_size, (2, 1), generator=g).to(dev)
        kw = dict(page_tokens=16)
        res = []
        lg, caches = tfm.prefill(cfg, p, {"tokens": toks}, max_cache_len=96)
        res.append(lg)
        lg, caches = tfm.extend(cfg, p, caches, ext, 40, **kw)
        res.append(lg)
        lg, caches = tfm.decode(cfg, p, caches, last, torch.tensor([70, 70], device=dev),
                                active=torch.tensor([True, False], device=dev), **kw)
        res.append(lg[:1])
        outs[dev] = [r.float().cpu() for r in res]
        rings[dev] = [a.float().cpu() for a in param.tree_leaves(caches)]
    errs = []
    for a, b in zip(outs["cuda"] + rings["cuda"], outs["cpu"] + rings["cpu"]):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        errs.append(rel)
        if not (rel < 1e-4 and torch.isfinite(a).all()):
            raise AssertionError(f"reduced ring steps on CUDA vs CPU: relative error {rel}")
    c = cfg_mod.reduced(cfg_mod.get_config("qwen3-8b"), dtype="float32",
                        param_dtype="float32", head_dim=128, n_heads=8, n_kv_heads=2,
                        d_model=256)
    qp = tfm.init_params(c, 0, device="cuda")
    runs = {}
    for mode in ("off", "on"):
        args = serve.parser().parse_args(["--arch", "qwen3-8b", "--page-tokens", "16",
                                          "--chunk-tokens", "16", "--paged-kernel", mode])
        eng = serve.build_engine(args, c, c, qp, device="cuda")
        eng.ecfg.eos_token = -1
        prompts = serve.make_prompts(c, 4, 32, args.seed)
        eng.submit(prompts[0], max_new_tokens=6)
        eng.run_until_idle()
        for pr in prompts[1:]:
            eng.submit(pr, max_new_tokens=6)
        rep = eng.run_until_idle()
        runs[mode] = ({k: list(v) for k, v in eng.outputs.items()}, rep)
    checks = {
        "ring_equals_paged": runs["off"][0] == runs["on"][0],
        "ring_hit": runs["off"][1]["prefix"]["compute_hits"] >= 1,
        "ring_seed_copy": runs["off"][1]["seed_copy_bytes"] > 0,
        "paged_zero_copy": runs["on"][1]["seed_copy_bytes"] == 0,
    }
    emit("reduced_ring_check", arch="gemma2-27b", relative_err=errs, tolerance=1e-4,
         engines="qwen3-8b ring vs paged", checks=checks)
    _require("reduced ring", checks)


def reduced_ring_multiarch_phase(torch, cfg_mod, tfm, param, serve):
    """The ring path of the stacks this slice adds, reduced fp32: mamba2-2.7b
    (the SSD scan from the carried state), hymba-1.5b (8 meta tokens; the
    flash forward, the position mode at D 32 under the window of 64, which
    the extend wraps, and the scan) and deepseek-v2-lite-16b (the latent
    position mode at D 80, one plane): a 40-token prefill of two rows into
    rings of 96 read as pages of 16, a 30-token extend and one decode round
    with row 1 inactive, CUDA (the kernels) against the CPU (the plain
    versions), same weights, logits and every ring leaf; then on CUDA the
    ring and paged engines of reduced hymba at page 4 (first chunks across
    pages: ROADMAP §C.5) and of reduced deepseek at page and chunk 16
    decode the same tokens, the ring hits seeding from snapshots."""
    errs = {}
    for arch in ("mamba2-2.7b", "hymba-1.5b", "deepseek-v2-lite-16b"):
        cfg = cfg_mod.reduced(cfg_mod.get_config(arch), dtype="float32",
                              param_dtype="float32")
        params = tfm.init_params(cfg, 0, device="cuda")
        plen = cfg.n_meta_tokens
        outs, rings = {}, {}
        for dev in ("cuda", "cpu"):
            p = param.tree_map(lambda a: a.to(dev), params)
            g = torch.Generator().manual_seed(2)
            toks = torch.randint(2, cfg.vocab_size, (2, 40), generator=g).to(dev)
            ext = torch.randint(2, cfg.vocab_size, (2, 30), generator=g).to(dev)
            last = torch.randint(2, cfg.vocab_size, (2, 1), generator=g).to(dev)
            res = []
            lg, caches = tfm.prefill(cfg, p, {"tokens": toks}, max_cache_len=96,
                                     page_tokens=16)
            res.append(lg)
            lg, caches = tfm.extend(cfg, p, caches, ext, plen + 40, page_tokens=16)
            res.append(lg)
            cur = torch.tensor([plen + 70] * 2, device=dev)
            lg, caches = tfm.decode(cfg, p, caches, last, cur, page_tokens=16,
                                    active=torch.tensor([True, False], device=dev))
            res.append(lg[:1])
            outs[dev] = [r.float().cpu() for r in res]
            rings[dev] = [a.float().cpu() for a in param.tree_leaves(caches)]
        errs[arch] = []
        for a, b in zip(outs["cuda"] + rings["cuda"], outs["cpu"] + rings["cpu"]):
            rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
            errs[arch].append(rel)
            if not (rel < 1e-4 and torch.isfinite(a).all()):
                raise AssertionError(f"reduced {arch} ring steps on CUDA vs CPU: "
                                     f"relative error {rel}")
    checks = {}
    for arch, flags in (("hymba-1.5b", ["--page-tokens", "4"]),
                        ("deepseek-v2-lite-16b", ["--page-tokens", "16",
                                                  "--chunk-tokens", "16"])):
        c = cfg_mod.reduced(cfg_mod.get_config(arch), dtype="float32",
                            param_dtype="float32")
        w = tfm.init_params(c, 0, device="cuda")
        runs = {}
        for mode in ("off", "on"):
            args = serve.parser().parse_args(["--arch", arch, *flags, "--paged-kernel", mode])
            eng = serve.build_engine(args, c, c, w, device="cuda")
            eng.ecfg.eos_token = -1
            prompts = serve.make_prompts(c, 4, 32, args.seed)
            eng.submit(prompts[0], max_new_tokens=6)
            eng.run_until_idle()
            for pr in prompts[1:]:
                eng.submit(pr, max_new_tokens=6)
            rep = eng.run_until_idle()
            runs[mode] = ({k: list(v) for k, v in eng.outputs.items()}, rep)
        checks[f"{arch}_ring_equals_paged"] = runs["off"][0] == runs["on"][0]
        checks[f"{arch}_ring_hit_seeds"] = (runs["off"][1]["prefix"]["compute_hits"] >= 1
                                            and runs["off"][1]["seed_copy_bytes"] > 0)
    emit("reduced_ring_check", archs=sorted(errs), relative_err=errs, tolerance=1e-4,
         engines="hymba-1.5b (page 4) and deepseek-v2-lite-16b ring vs paged",
         checks=checks)
    _require("reduced ring (MLA, SSM, hybrid)", checks)


def reduced_hybrid_phase(torch, cfg_mod, tfm, param, serve):
    """Reduced fp32 hymba-1.5b (8 meta tokens) at page 16: paged prefill
    (meta + 8 prompt tokens, page 0), extend (page 1) and a batched decode
    with an inactive row, CUDA (both kernels in every layer) against the
    CPU path, same weights; then, on CUDA at page 4, where every first
    chunk (8 meta tokens + 4) spans three pages, in fp32 and in bf16, an
    engine whose prefix hits resume from state pages decodes the tokens of
    a cold start."""
    full = cfg_mod.get_config("hymba-1.5b")
    cfg = cfg_mod.reduced(full, dtype="float32", param_dtype="float32")
    params = tfm.init_params(cfg, 0, device="cuda")
    pt = 16
    outs = {}
    for dev in ("cuda", "cpu"):
        p = param.tree_map(lambda a: a.to(dev), params)
        caches = tfm.init_paged_caches(cfg, 8, pt, torch.float32, device=dev)
        g = torch.Generator().manual_seed(3)
        toks = torch.randint(2, cfg.vocab_size, (1, pt - cfg.n_meta_tokens),
                             generator=g).to(dev)
        ext = torch.randint(2, cfg.vocab_size, (1, 6), generator=g).to(dev)
        last = torch.randint(2, cfg.vocab_size, (2, 1), generator=g).to(dev)
        tbl = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32, device=dev)
        tbl2 = torch.tensor([[1, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32,
                            device=dev)
        res = []
        lg, caches = tfm.paged_prefill(cfg, p, {"tokens": toks}, caches, tbl,
                                       page_tokens=pt)
        res.append(lg)
        lg, caches = tfm.paged_extend(cfg, p, caches, ext, pt, tbl,
                                      page_tokens=pt)
        res.append(lg)
        lg, caches = tfm.paged_decode(cfg, p, caches, last,
                                      torch.tensor([pt + 6, 0], device=dev),
                                      tbl2, page_tokens=pt,
                                      active=torch.tensor([True, False], device=dev))
        res.append(lg[:1])
        outs[dev] = [r.float().cpu() for r in res]
    errs = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        errs.append(rel)
        if not rel < 1e-4:
            raise AssertionError(f"reduced hymba on CUDA vs CPU: relative "
                                 f"logit error {rel}")
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on CUDA")

    cfg16 = cfg_mod.reduced(full)                     # bf16
    hits, skipped = {}, {}
    for dname, c, w in (("float32", cfg, params),
                        ("bfloat16", cfg16, tfm.init_params(cfg16, 0, device="cuda"))):
        same, hits[dname], skipped[dname] = engine_hit_equals_cold(
            serve, "hymba-1.5b", c, full, w, ["--page-tokens", "4"])
        if not same or hits[dname] < 1:
            raise AssertionError(f"reduced hymba on CUDA, {dname}, page 4: "
                                 f"prefix hit ({hits[dname]} hits) does not "
                                 "decode the cold-start tokens")
    emit("reduced_model_check", arch="hymba-1.5b", relative_logit_err=errs,
         tolerance=1e-4, hit_equals_cold_page4={"float32": True, "bfloat16": True},
         compute_hits=hits, prefill_tokens_skipped=skipped)


def reduced_mla_phase(torch, cfg_mod, tfm, param, serve):
    """Reduced fp32 deepseek-v2-lite-16b (MLA on D 80 latent pages, 4
    experts top-2 behind one dense layer): paged prefill of 40 tokens over
    three pages, a 9-token extend and a batched decode with an inactive
    row, CUDA (the kernel) against the CPU path, same weights; then, on
    CUDA, in fp32 and in bf16, an engine at page 16 and chunk 16 (cold and
    hit cut prompts at the same boundaries, so MoE groups and capacities
    match) whose prefix hits decode the tokens of a cold start."""
    full = cfg_mod.get_config("deepseek-v2-lite-16b")
    cfg = cfg_mod.reduced(full, dtype="float32", param_dtype="float32")
    params = tfm.init_params(cfg, 0, device="cuda")
    pt = 16
    outs = {}
    for dev in ("cuda", "cpu"):
        p = param.tree_map(lambda a: a.to(dev), params)
        caches = tfm.init_paged_caches(cfg, 8, pt, torch.float32, device=dev)
        g = torch.Generator().manual_seed(4)
        toks = torch.randint(2, cfg.vocab_size, (1, 40), generator=g).to(dev)
        ext = torch.randint(2, cfg.vocab_size, (1, 9), generator=g).to(dev)
        last = torch.randint(2, cfg.vocab_size, (2, 1), generator=g).to(dev)
        tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=dev)
        tbl2 = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0]], dtype=torch.int32,
                            device=dev)
        res = []
        lg, caches = tfm.paged_prefill(cfg, p, {"tokens": toks}, caches, tbl)
        res.append(lg)
        lg, caches = tfm.paged_extend(cfg, p, caches, ext, 40, tbl)
        res.append(lg)
        lg, caches = tfm.paged_decode(cfg, p, caches, last,
                                      torch.tensor([49, 0], device=dev), tbl2,
                                      active=torch.tensor([True, False], device=dev))
        res.append(lg[:1])
        outs[dev] = [r.float().cpu() for r in res]
    errs = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        errs.append(rel)
        if not rel < 1e-4:
            raise AssertionError(f"reduced deepseek-v2-lite on CUDA vs CPU: "
                                 f"relative logit error {rel}")
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on CUDA")

    cfg16 = cfg_mod.reduced(full)                     # bf16
    flags = ["--page-tokens", str(pt), "--chunk-tokens", str(pt)]
    hits, skipped = {}, {}
    for dname, c, w in (("float32", cfg, params),
                        ("bfloat16", cfg16, tfm.init_params(cfg16, 0, device="cuda"))):
        same, hits[dname], skipped[dname] = engine_hit_equals_cold(
            serve, "deepseek-v2-lite-16b", c, full, w, flags)
        if not same or hits[dname] < 1:
            raise AssertionError(f"reduced deepseek-v2-lite on CUDA, {dname}: "
                                 f"prefix hit ({hits[dname]} hits) does not "
                                 "decode the cold-start tokens")
    emit("reduced_model_check", arch="deepseek-v2-lite-16b", relative_logit_err=errs,
         tolerance=1e-4, hit_equals_cold_page16_chunk16={"float32": True,
                                                        "bfloat16": True},
         compute_hits=hits, prefill_tokens_skipped=skipped)


def reduced_frontend_phase(torch, cfg_mod, tfm, param, serve, frontends, arch):
    """Reduced fp32 mixtral-8x22b (8 experts top-2, window 64), musicgen-large
    (4 codebooks) or internvl2-76b (8 patch embeddings): a 40-token first
    chunk (internvl2: behind its patch embeddings) over three pages of 16,
    a 9-token extend and a batched decode with an inactive row, CUDA (the
    kernel) against the CPU path, same weights (wq and wk conditioned, see
    ``conditioned``: at the reference's fan-in std of 0.5 on 4 heads the
    scores saturate, and the reference's own fp32 logits move by up to 4e-5
    under a one-ulp weight nudge). Then, on CUDA, in fp32 and in bf16, an
    engine at page and chunk 16 whose prefix hits decode the tokens of a
    cold start."""
    full = cfg_mod.get_config(arch)
    kw = {"n_experts": 8} if arch == "mixtral-8x22b" else {}
    cfg = cfg_mod.reduced(full, dtype="float32", param_dtype="float32", **kw)
    params = tfm.init_params(cfg, 0, device="cuda")
    cond = conditioned(params, cfg.d_model)
    pt = 16
    image = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    outs = {}
    for dev in ("cuda", "cpu"):
        p = param.tree_map(lambda a: a.to(dev), cond)
        caches = tfm.init_paged_caches(cfg, 8, pt, torch.float32, device=dev)
        batch = frontends.sample_batch(cfg, 1, image + 40, seed=5,
                                       with_labels=False, device=dev)
        g = torch.Generator().manual_seed(6)
        ext = torch.randint(0, cfg.vocab_size, (1, 9) + tail, generator=g).to(dev)
        last = torch.randint(0, cfg.vocab_size, (2, 1) + tail, generator=g).to(dev)
        tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=dev)
        tbl2 = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0]], dtype=torch.int32,
                            device=dev)
        res = []
        lg, caches = tfm.paged_prefill(cfg, p, batch, caches, tbl)
        res.append(lg)
        lg, caches = tfm.paged_extend(cfg, p, caches, ext, image + 40, tbl)
        res.append(lg)
        lg, caches = tfm.paged_decode(cfg, p, caches, last,
                                      torch.tensor([image + 49, 0], device=dev),
                                      tbl2, active=torch.tensor([True, False],
                                                                device=dev))
        res.append(lg[:1])
        outs[dev] = [r.float().cpu() for r in res]
    errs = []
    for a, b in zip(outs["cuda"], outs["cpu"]):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        errs.append(rel)
        if not rel < 1e-4:
            raise AssertionError(f"reduced {arch} on CUDA vs CPU: relative "
                                 f"logit error {rel}")
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on CUDA")

    cfg16 = cfg_mod.reduced(full, **kw)               # bf16
    flags = ["--page-tokens", str(pt), "--chunk-tokens", str(pt)]
    hits, skipped = {}, {}
    for dname, c, w in (("float32", cfg, params),
                        ("bfloat16", cfg16, tfm.init_params(cfg16, 0, device="cuda"))):
        same, hits[dname], skipped[dname] = engine_hit_equals_cold(
            serve, arch, c, full, w, flags)
        if not same or hits[dname] < 1:
            raise AssertionError(f"reduced {arch} on CUDA, {dname}: prefix hit "
                                 f"({hits[dname]} hits) does not decode the "
                                 "cold-start tokens")
    emit("reduced_model_check", arch=arch, relative_logit_err=errs,
         tolerance=1e-4, hit_equals_cold_page16_chunk16={"float32": True,
                                                        "bfloat16": True},
         compute_hits=hits, prefill_tokens_skipped=skipped)


# ---------------------------------------------------------------------------
# Main path at full width and depth
# ---------------------------------------------------------------------------


def run_serve(torch, cfg_mod, tfm, serve, param, arch, kernels, layers=None,
              ring_slots=None, keep=None):
    """Drive one serving path once at full width: ``arch`` with nothing
    reduced but, where ``layers`` is given, its depth (the first ``layers``
    layers; the memory plane still meters the published config, as the
    launcher meters it behind a reduced compute config), random weights
    from ``launch/serve.py``'s seed and defaults, 8 requests x 16 new
    tokens behind a shared 32-token head (the first alone, publishing the
    head; then the rest). Every kernel wrapper in ``kernels`` has its launch
    count set to 0 just before the run and read just after. With
    ``ring_slots`` the paged engine is then freed and the ring engine
    (``--paged-kernel off``, rings of ``ring_slots``) serves the same
    prompts on the same weights (``drive_ring_serve``); its stats, with the
    share of its tokens equal to the paged engine's, land in
    ``stats["ring"]`` and its launches in ``stats["ring_launches"]``. A
    ``keep`` dict receives the weights, configs, arguments and prompts, for
    a later phase to serve on the same draw.
    Returns (cfg, report, launches, stats), ``cfg`` the config that
    computed."""
    import dataclasses
    full = cfg_mod.get_config(arch)          # nothing reduced
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    args = serve.parser().parse_args(["--arch", arch])   # serve defaults
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in param.tree_leaves(params))
    eng = serve.build_engine(args, cfg, full, params, device="cuda")
    # random weights may emit the default eos (1) and end a request early;
    # the config object is shared by the engine's parts
    eng.ecfg.eos_token = -1
    prompts = serve.make_prompts(cfg, 8, 32, args.seed)

    finite = []
    sample = eng.backend.sample

    def checked_sample(logits):
        finite.append(bool(torch.isfinite(logits).all()))
        return sample(logits)

    eng.backend.sample = checked_sample
    decode_s = [0.0]
    run_decode = eng.backend.run_decode

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        out = run_decode(*a, **kw)          # ends in a host copy: synchronous
        decode_s[0] += time.perf_counter() - t
        return out

    eng.backend.run_decode = timed_decode
    first_rows = []                         # rows of each prompt's first chunk
    run_chunk = eng.backend.run_prefill_chunk

    def recorded_chunk(ck, *a, **kw):
        if ck.first:
            first_rows.append(ck.offset + len(ck.tokens))
        return run_chunk(ck, *a, **kw)

    eng.backend.run_prefill_chunk = recorded_chunk
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    eng.backend.model_calls = 0
    t0 = time.perf_counter()
    eng.submit(prompts[0], max_new_tokens=args.max_new)
    eng.run_until_idle()
    first_s = time.perf_counter() - t0
    for p in prompts[1:]:
        eng.submit(p, max_new_tokens=args.max_new)
    rep = eng.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    decode_tokens = rep["tokens_generated"] - rep["finished"]
    if keep is not None:
        keep.update(cfg=cfg, full=full, params=params, prompts=prompts,
                    wall_s=wall_s, report=rep, launches=launches,
                    tokens={k: [int(t) for t in v]
                                           for k, v in eng.outputs.items()})
    stats = dict(
        arch=cfg.name, layers=cfg.num_layers, published_layers=full.num_layers,
        d_model=cfg.d_model,
        vocab=cfg.vocab_size, dtype=cfg.dtype, weight_bytes=weight_bytes,
        pool_bytes=sum(t.numel() * t.element_size()
                       for t in param.tree_leaves(eng.backend.paged_caches)),
        init_s=init_s, first_request_s=first_s, wall_s=wall_s,
        decode_s=decode_s[0], decode_tokens=decode_tokens,
        decode_tokens_per_s=decode_tokens / decode_s[0],
        tokens_per_s=rep["tokens_generated"] / wall_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        model_calls=eng.backend.model_calls, kernel_launches=launches,
        finished=rep["finished"], tokens_generated=rep["tokens_generated"],
        prefill_chunks=rep["prefill_chunks"],
        first_chunk_rows_max=max(first_rows, default=0),
        prefill_tokens_skipped=rep["prefill_tokens_skipped"],
        compute_hits=rep["prefix"]["compute_hits"],
        snapshot_kind=rep["prefix"]["snapshot_kind"],
        kernel_read_bytes=rep["kernel_read_bytes"],
        seed_copy_bytes=rep["seed_copy_bytes"],
        finite_logits=bool(finite) and all(finite))
    if ring_slots:
        paged_tokens = {k: [int(t) for t in v] for k, v in eng.outputs.items()}
        eng.backend.paged_caches = None     # the wrappers above keep the backend
        del eng
        ring, ring_tokens, ring_launches = drive_ring_serve(
            torch, serve, param, args, cfg, params, kernels, paged=False, prompts=prompts,
            max_new=args.max_new, max_cache_len=ring_slots, full=full)
        same = sum(a == b for r in ring_tokens
                   for a, b in zip(ring_tokens[r], paged_tokens[r]))
        ring["tokens_equal_paged_share"] = same / sum(map(len, ring_tokens.values()))
        stats.update(ring=ring, ring_launches=ring_launches)
    return cfg, rep, launches, stats


def ring_checks(ring: dict) -> dict:
    """The ring run's own checks in a serve phase: every request finished
    with its tokens, finite logits, and a hit seeded from a ring snapshot."""
    return {"ring_finished": ring["finished"] == 8,
            "ring_tokens_generated": ring["tokens_generated"] == 8 * 16,
            "ring_finite_logits": ring["finite_logits"],
            "ring_hit_seeds": ring["compute_hits"] >= 1 and ring["seed_copy_bytes"] > 0
            and ring["snapshots_published"] >= 1 and ring["kernel_read_bytes"] == 0}


def _require(phase: str, checks: dict) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


def serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi, keep=None):
    """qwen3-8b: every layer of every model call launched the attention
    kernel. ``keep`` receives the weights for the fleet phase."""
    cfg, rep, launches, st = run_serve(torch, cfg_mod, tfm, serve, param,
                                       "qwen3-8b", kernels, keep=keep)
    n = launches["ragged_paged_attention"]
    calls = st["model_calls"]
    checks = {
        "finished": rep["finished"] == 8,
        "tokens_generated": rep["tokens_generated"] == 8 * 16,
        "finite_logits": st["finite_logits"],
        "launches": n == cfg.num_layers * calls and calls > 0,
        "seed_copy_bytes": rep["seed_copy_bytes"] == 0,
        "kernel_read_bytes": rep["kernel_read_bytes"] > 0,
        "compute_hits": rep["prefix"]["compute_hits"] >= 1,
    }
    emit("serve", nvidia_smi=smi, **st, checks=checks)
    _require("qwen3-8b serve", checks)
    return n


def ssm_serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi):
    """mamba2-2.7b: every layer of every prefill chunk launched the SSD
    kernel (decode runs the plain recurrence); prefix hits resumed from
    state pages with zero copy bytes."""
    cfg, rep, launches, st = run_serve(torch, cfg_mod, tfm, serve, param,
                                       "mamba2-2.7b", kernels, ring_slots=LATENT_RING)
    n = launches["ssd_scan"]
    chunks = rep["prefill_chunks"]
    ring, rl = st["ring"], st["ring_launches"]
    checks = {
        "finished": rep["finished"] == 8,
        "tokens_generated": rep["tokens_generated"] == 8 * 16,
        "finite_logits": st["finite_logits"],
        "full_width": (cfg.num_layers, cfg.d_model, cfg.ssm_nheads,
                       cfg.ssm_headdim, cfg.ssm_state, cfg.dtype)
        == (64, 2560, SSD_H, SSD_P, SSD_N, "bfloat16"),
        "launches": n == cfg.num_layers * chunks and chunks > 0,
        "seed_copy_bytes": rep["seed_copy_bytes"] == 0,
        "snapshot_kind": rep["prefix"]["snapshot_kind"] == "point",
        "compute_hits": rep["prefix"]["compute_hits"] >= 1,
        **ring_checks(ring),
        # the ring path: every layer of every prefill chunk scanned from the
        # slot's carried state; no attention
        "ring_ssd_launches": rl["ssd_scan"] == cfg.num_layers * ring["prefill_chunks"]
        and ring["prefill_chunks"] > 0,
        "ring_no_attention": rl["ragged_paged_attention"] == 0
        and rl["flash_attention_fwd"] == 0,
        "ring_point_snapshots": ring["snapshot_kind"] == "point"
        and ring["live_snapshot_kinds"] == ["point"],
    }
    emit("ssm_serve", nvidia_smi=smi, **st,
         state_page_bytes=cfg.ssm_state_bytes_layer(), checks=checks)
    _require("mamba2-2.7b serve", checks)
    return launches, rl


def hybrid_serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi):
    """hymba-1.5b: every layer of every model call launched the attention
    kernel, and every layer of every prefill chunk the SSD kernel; the
    shared head ends at 128 + 32 = 160, a page boundary, so hits resume
    from a state page with zero copy bytes."""
    cfg, rep, launches, st = run_serve(torch, cfg_mod, tfm, serve, param,
                                       "hymba-1.5b", kernels, ring_slots=HYMBA_RING)
    n_rpa, n_ssd = launches["ragged_paged_attention"], launches["ssd_scan"]
    calls, chunks = st["model_calls"], rep["prefill_chunks"]
    ring, rl = st["ring"], st["ring_launches"]
    L, firsts = cfg.num_layers, ring["first_chunks"]
    checks = {
        "finished": rep["finished"] == 8,
        "tokens_generated": rep["tokens_generated"] == 8 * 16,
        "finite_logits": st["finite_logits"],
        "full_width": (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.ssm_nheads, cfg.ssm_state,
                       cfg.n_meta_tokens, cfg.dtype)
        == (32, 1600, 25, 5, 64, 50, 16, 128, "bfloat16"),
        "attention_launches": n_rpa == cfg.num_layers * calls and calls > 0,
        "ssd_launches": n_ssd == cfg.num_layers * chunks and chunks > 0,
        "seed_copy_bytes": rep["seed_copy_bytes"] == 0,
        "snapshot_kind": rep["prefix"]["snapshot_kind"] == "point",
        "compute_hits": rep["prefix"]["compute_hits"] >= 1,
        **ring_checks(ring),
        # the ring path: the flash forward at every layer of every first
        # chunk, the position mode at every layer of every later model call,
        # the SSD scan at every layer of every prefill chunk
        "ring_flash_launches": rl["flash_attention_fwd"] == L * firsts and firsts > 0,
        "ring_position_mode_launches": rl["ragged_paged_attention"]
        == L * (ring["model_calls"] - firsts) and ring["model_calls"] > firsts,
        "ring_ssd_launches": rl["ssd_scan"] == L * ring["prefill_chunks"],
        "ring_point_snapshots": ring["snapshot_kind"] == "point"
        and ring["live_snapshot_kinds"] == ["point"],
    }
    emit("hybrid_serve", nvidia_smi=smi, **st,
         state_page_bytes=cfg.ssm_state_bytes_layer(), checks=checks)
    _require("hymba-1.5b serve", checks)
    return launches, rl


def mla_serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi):
    """deepseek-v2-lite-16b: every MLA layer of every model call launched
    the attention kernel at the latent head (D 576, 16 query heads on one
    KV head); prefix hits spliced pages with zero copy bytes."""
    cfg, rep, launches, st = run_serve(torch, cfg_mod, tfm, serve, param,
                                       "deepseek-v2-lite-16b", kernels,
                                       ring_slots=LATENT_RING)
    n = launches["ragged_paged_attention"]
    calls = st["model_calls"]
    specs = cfg.layer_specs()
    ring, rl = st["ring"], st["ring_launches"]
    checks = {
        "finished": rep["finished"] == 8,
        "tokens_generated": rep["tokens_generated"] == 8 * 16,
        "finite_logits": st["finite_logits"],
        "full_width": (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                       cfg.qk_rope_dim, cfg.n_experts, cfg.moe_top_k,
                       cfg.n_shared_experts, cfg.expert_d_ff, cfg.vocab_size, cfg.dtype)
        == (27, 2048, 16, 512, 64, 64, 6, 2, 1408, 102400, "bfloat16"),
        "mla_moe_layers": all(s.kind == "mla" for s in specs)
        and [s.mlp for s in specs] == ["dense"] + ["moe"] * 26,
        "launches": n == cfg.num_layers * calls and calls > 0,
        "seed_copy_bytes": rep["seed_copy_bytes"] == 0,
        "kernel_read_bytes": rep["kernel_read_bytes"] > 0,
        "compute_hits": rep["prefix"]["compute_hits"] >= 1,
        **ring_checks(ring),
        # the ring path: the latent kernel in position mode at every layer
        # of every model call, first chunks included; no flash forward
        "ring_latent_launches": rl["ragged_paged_attention"]
        == cfg.num_layers * ring["model_calls"] and ring["model_calls"] > 0,
        "ring_no_flash": rl["flash_attention_fwd"] == 0,
        "ring_positional_snapshots": ring["snapshot_kind"] == "positional"
        and ring["live_snapshot_kinds"] == ["positional"],
    }
    emit("mla_serve", nvidia_smi=smi, **st,
         latent_bytes_token_layer=(cfg.kv_lora_rank + cfg.qk_rope_dim) * 2,
         checks=checks)
    _require("deepseek-v2-lite-16b serve", checks)
    return n, rl


def frontend_serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi,
                         phase, arch, full_width):
    """mixtral-8x22b (``moe_serve``: MoE of 8 experts top-2 and a 4096
    window in every layer, the first 8 of 56 layers), musicgen-large
    (``audio_serve``: 4 codebooks, all 48 layers) or internvl2-76b
    (``vision_serve``: 256 patch embeddings in front of every prompt, the
    first 8 of 80 layers) at full width: every layer of every model call
    launched the attention kernel; prefix hits spliced pages with zero copy
    bytes. ``full_width`` is the published widths the config must have."""
    cfg, rep, launches, st = run_serve(torch, cfg_mod, tfm, serve, param, arch,
                                       kernels, SERVE_LAYERS.get(arch))
    n = launches["ragged_paged_attention"]
    calls = st["model_calls"]
    widths = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
              cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts,
              cfg.expert_d_ff or cfg.d_ff, {s.window for s in cfg.layer_specs()},
              cfg.n_codebooks, cfg.n_frontend_tokens, cfg.vocab_size, cfg.dtype)
    checks = {
        "finished": rep["finished"] == 8,
        "tokens_generated": rep["tokens_generated"] == 8 * 16,
        "finite_logits": st["finite_logits"],
        "full_width": widths == full_width,
        "layers": cfg.num_layers == SERVE_LAYERS.get(arch, st["published_layers"]),
        "launches": n == cfg.num_layers * calls and calls > 0,
        "seed_copy_bytes": rep["seed_copy_bytes"] == 0,
        "kernel_read_bytes": rep["kernel_read_bytes"] > 0,
        "compute_hits": rep["prefix"]["compute_hits"] >= 1,
    }
    emit(phase, nvidia_smi=smi, **st, full_width=dict(zip(
        ("d_model", "n_heads", "n_kv_heads", "head_dim", "n_experts", "top_k",
         "shared_experts", "d_ff", "windows", "codebooks", "image_tokens",
         "vocab", "dtype"), [sorted(w, key=str) if isinstance(w, set) else w
                             for w in widths])),
         kv_bytes_token_layer=2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2,
         checks=checks)
    _require(f"{arch} serve", checks)
    return n


def device_busy_s(torch, prof) -> float:
    """Seconds in which the card ran anything: the union of the device
    activities' intervals (as ``scripts/profile_port_serve.py`` counts),
    read from the raw trace events without building the profiler's event
    tree."""
    from torch.autograd import DeviceType
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.name().startswith("Command Buffer"))
    busy, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        busy += end - start
    return busy / 1e9


RING_MAX_NEW = 32
RING_CACHE_LEN = 4800      # 150 pages of 32: the longest prompt + 32 fits


def ring_prompts(cfg, seed):
    """4 requests: a 1000-token donor (short of the 4096-slot local rings,
    so its finished rings publish a snapshot), then a 1192-token prompt
    sharing its first 992 tokens (31 pages: a hit) and two of 4400 and 4700
    tokens, past the 4096 window."""
    import numpy as np
    rng = np.random.default_rng(seed)
    head = rng.integers(2, cfg.vocab_size, 1000).tolist()
    return [head, head[:992] + rng.integers(2, cfg.vocab_size, 200).tolist(),
            rng.integers(2, cfg.vocab_size, 4400).tolist(),
            rng.integers(2, cfg.vocab_size, 4700).tolist()]


def drive_ring_serve(torch, serve, param, args, cfg, params, kernels, paged,
                     prompts=None, max_new=RING_MAX_NEW, max_cache_len=RING_CACHE_LEN,
                     full=None):
    """One engine over ``prompts`` (default ``ring_prompts``), ``max_new``
    new tokens each: the donor alone, then the rest, under
    ``torch.profiler`` (CUDA activity only) for the device-busy share of
    the run's wall time; every time is taken under it (on an H100 it added
    about 7% to the ring run's wall time). Every wrapper's count is zeroed
    just before and read just after. Returns (stats, tokens, launches)."""
    args.paged_kernel = "on" if paged else "off"
    eng = serve.build_engine(args, cfg, full or cfg, params, device="cuda",
                             max_cache_len=max_cache_len)
    eng.ecfg.eos_token = -1     # random weights may emit the default eos
    prompts = prompts or ring_prompts(cfg, args.seed)
    finite, firsts, decode_s = [], [0], [0.0]
    sample, run_decode, run_chunk = (eng.backend.sample, eng.backend.run_decode,
                                     eng.backend.run_prefill_chunk)

    def checked_sample(logits):
        finite.append(bool(torch.isfinite(logits).all()))
        return sample(logits)

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        out = run_decode(*a, **kw)          # ends in a host copy: synchronous
        decode_s[0] += time.perf_counter() - t
        return out

    def counted_chunk(ck, *a, **kw):
        firsts[0] += ck.first
        return run_chunk(ck, *a, **kw)

    eng.backend.sample, eng.backend.run_decode = checked_sample, timed_decode
    eng.backend.run_prefill_chunk = counted_chunk
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.submit(prompts[0], max_new_tokens=max_new)
        eng.run_until_idle()
        for pr in prompts[1:]:
            eng.submit(pr, max_new_tokens=max_new)
        rep = eng.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
    decode_tokens = rep["tokens_generated"] - rep["finished"]
    caches = eng.backend.paged_caches if paged else eng.backend.caches
    stats = dict(
        engine="paged" if paged else "ring", wall_s=wall_s, decode_s=decode_s[0],
        decode_tokens=decode_tokens, decode_tokens_per_s=decode_tokens / decode_s[0],
        tokens_per_s=rep["tokens_generated"] / wall_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        cache_bytes=sum(t.numel() * t.element_size() for t in param.tree_leaves(caches)),
        model_calls=eng.backend.model_calls, first_chunks=firsts[0],
        prefill_chunks=rep["prefill_chunks"], kernel_launches=launches,
        finished=rep["finished"], tokens_generated=rep["tokens_generated"],
        compute_hits=rep["prefix"]["compute_hits"],
        prefill_tokens_skipped=rep["prefill_tokens_skipped"],
        seed_copy_bytes=rep["seed_copy_bytes"], snapshot_bytes=rep["snapshot_bytes"],
        snapshots_published=rep["prefix"]["snapshots_published"],
        snapshot_kind=rep["prefix"]["snapshot_kind"],
        live_snapshot_kinds=sorted({n.payload.kind for n in eng.kv.radix.nodes()
                                    if getattr(n.payload, "live", False)}),
        kernel_read_bytes=rep["kernel_read_bytes"],
        finite_logits=bool(finite) and all(finite),
        max_position=max(len(p) for p in prompts) + max_new - 1)
    if not paged:   # a local ring wrapped: it holds positions past its slots
        stats["local_ring_max_position"] = max(
            (int(caches[gi][u]["pos"].max())
             for gi, g in enumerate(cfg.scan_groups()) for u, spec in enumerate(g.unit)
             if spec.window is not None and spec.kind == "attn"), default=None)
    busy = device_busy_s(torch, prof)
    stats.update(device_busy_s=busy, device_idle_share=1 - busy / wall_s)
    tokens = {k: [int(t) for t in v] for k, v in eng.outputs.items()}
    del eng, caches
    gc.collect()
    torch.cuda.empty_cache()
    return stats, tokens, launches


def ring_serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi):
    """gemma2-27b at full width and depth (46 layers, d 4608, GQA 32/16 at
    128, the 4096 window on alternate layers, softcaps 50/30, post-norms,
    GeGLU d_ff 36864, vocab 256000, bf16, 27.2B parameters), weights drawn
    once from the serve seed: the ring engine, freed, then the paged
    engine, on the same 4 prompts (1000 to 4700 tokens, 32 new each;
    ``--paged-kernel off``/``on`` with the serve defaults and rings of 4800
    slots). Every layer of every first chunk launched the flash forward and
    every layer of every later ring chunk and decode round the paged
    kernel in position mode; the paged engine launched the paged kernel in
    every layer of every model call. Each engine runs under the profiler,
    for its device idle share."""
    cfg = cfg_mod.get_config("gemma2-27b")        # nothing reduced
    args = serve.parser().parse_args(["--arch", "gemma2-27b"])   # serve defaults
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in param.tree_leaves(params))
    ring, ring_tokens, ring_launches = drive_ring_serve(
        torch, serve, param, args, cfg, params, kernels, paged=False)
    paged, paged_tokens, paged_launches = drive_ring_serve(
        torch, serve, param, args, cfg, params, kernels, paged=True)
    L = cfg.num_layers
    same = sum(a == b for r in ring_tokens for a, b in zip(ring_tokens[r], paged_tokens[r]))
    total = sum(len(v) for v in ring_tokens.values())
    windowed = [s.window for s in cfg.layer_specs()]
    checks = {
        "full_width": (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
                       cfg.attn_softcap, cfg.final_softcap, cfg.post_norms, cfg.dtype)
        == (46, 4608, 32, 16, 128, 36864, 256000, 50.0, 30.0, True, "bfloat16"),
        "windows": windowed == [GEMMA2_WINDOW, None] * 23,
        "finished": ring["finished"] == paged["finished"] == 4,
        "tokens_generated": ring["tokens_generated"] == paged["tokens_generated"]
        == 4 * RING_MAX_NEW,
        "finite_logits": ring["finite_logits"] and paged["finite_logits"],
        # a hit resumes with an extend: one first chunk a request without one
        "ring_flash_launches": ring_launches["flash_attention_fwd"] == L * ring["first_chunks"]
        and ring["first_chunks"] == 4 - ring["compute_hits"],
        "ring_position_mode_launches": ring_launches["ragged_paged_attention"]
        == L * (ring["model_calls"] - ring["first_chunks"]) and ring["model_calls"] > 4,
        "paged_launches": paged_launches["ragged_paged_attention"] == L * paged["model_calls"]
        and paged_launches["flash_attention_fwd"] == 0,
        # the window binds: queries reach past 4096 + the first keys, so the
        # local layers mask keys (the paged pages keep them; the local ring
        # has overwritten them)
        "window_binds": paged["max_position"] >= GEMMA2_WINDOW + 512
        and ring["local_ring_max_position"] >= GEMMA2_WINDOW + 512,
        "ring_hit_seeds": ring["compute_hits"] >= 1 and ring["seed_copy_bytes"] > 0,
        "paged_hit_zero_copy": paged["compute_hits"] >= 1 and paged["seed_copy_bytes"] == 0,
    }
    emit("ring_serve", nvidia_smi=smi, arch=cfg.name, layers=L, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=cfg.dtype, weight_bytes=weight_bytes, init_s=init_s,
         ring_slots={"global": RING_CACHE_LEN, "local": GEMMA2_WINDOW},
         page_tokens=args.page_tokens, ring=ring, paged=paged,
         ring_tokens_equal_paged_share=same / total, checks=checks)
    _require("gemma2-27b ring serve", checks)
    return ring_launches, paged_launches


# ---------------------------------------------------------------------------
# Training: reduced gemma-2b CUDA vs CPU, then full width and depth
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the fleet: the cluster frontend over torch replicas, and fault injection
# ---------------------------------------------------------------------------

FLEET_ARCHS = (("deepseek-7b", False), ("mamba2-2.7b", False),
               ("deepseek-v2-lite-16b", False), ("hymba-1.5b", False),
               ("qwen3-8b", True))          # (arch, paged plane): the ring path else
FLEET_ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
                  eos_token=-1, chunk_tokens=16, page_tokens=16)
# which kernel entry each reduced-fleet arch's launches land in
FLEET_MODES = {"deepseek-7b": "ragged_paged_attention_positions",
               "hymba-1.5b": "ragged_paged_attention_positions",
               "deepseek-v2-lite-16b": "ragged_paged_attention_latent_positions",
               "qwen3-8b": "ragged_paged_attention"}


def fleet_prompts():
    """The reference tests' fan-out: a 48-token shared head alone, then
    three prompts behind it, each on its own session key."""
    import numpy as np
    rng = np.random.default_rng(17)
    shared = [int(x) for x in rng.integers(2, 400, 48)]
    return [list(shared)] + [shared + [int(x) for x in rng.integers(2, 400, 8)]
                             for _ in range(3)]


def fleet_sums_match(rep) -> bool:
    """The fleet report's tokens and per-tier bytes equal the sums of its
    per-replica reports."""
    reps = rep["per_replica"]
    if rep["tokens_generated"] != sum(r["tokens_generated"] for r in reps):
        return False
    for name, tier in rep["tiers"].items():
        for k in ("read_gb", "write_gb"):
            total = 0.0
            for r in reps:
                total += r["memory"]["tiers"][name][k]
            if tier[k] != total:
                return False
    return True


def reduced_fleet_phase(torch, cfg_mod, tfm, kernels):
    """Two replicas of a reduced fp32 engine (page and chunk 16: the
    reference tests' settings) behind ``ClusterFrontend`` with
    ``migrate_prefixes=True`` and ``migrate_load_gap=-1`` (a queued owner
    always loses the request), on CUDA, for deepseek-7b (ring, positional
    snapshots), mamba2-2.7b (ring, point snapshots), deepseek-v2-lite-16b
    (the MLA ring), hymba-1.5b (the hybrid ring) and qwen3-8b (paged), under
    the lockstep and the event clock: a migrated hit that skipped prefill on
    the receiver, the fan-out's tokens equal to a cold CUDA engine's, the
    lockstep tokens equal to the event tokens, and the fleet report's tokens
    and per-tier bytes equal to the sums of the per-replica reports. Every
    wrapper's count is zeroed before each fleet run and read after it.
    Returns each kernel entry's launches on these runs."""
    from repro_torch.core.memclass import HBM3E, MRM_RRAM
    from repro_torch.core.simulator import MemorySystem
    from repro_torch.serving import ClusterFrontend, EngineConfig, ServeEngine
    prompts = fleet_prompts()

    def engine(cfg, full, params, paged, **kw):
        mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
        return ServeEngine(cfg, params, mem,
                           EngineConfig(**FLEET_ECFG, paged_kernel=paged, **kw),
                           account_cfg=full, device="cuda")

    by_entry, results, checks = {}, {}, {}
    for arch, paged in FLEET_ARCHS:
        full = cfg_mod.get_config(arch)
        cfg = cfg_mod.reduced(full, dtype="float32", param_dtype="float32")
        params = tfm.init_params(cfg, 0, device="cuda")
        runs = {}
        for clock in ("lockstep", "event"):
            fe = ClusterFrontend([engine(cfg, full, params, paged) for _ in range(2)],
                                 migrate_prefixes=True, migrate_load_gap=-1,
                                 clock_mode=clock, record_trace=True)
            for fn in kernels:
                fn.launches = 0
            rids = []
            for i, pr in enumerate(prompts):
                rids.append(fe.submit(list(pr), 6, session_key=f"u{i}"))
                fe.run_until_idle()
            rep = fe.run_until_idle()
            launches = {fn.__name__: fn.launches for fn in kernels}
            home = fe.replica_of(rids[0])
            runs[clock] = dict(
                tokens=[[int(t) for t in fe.output(r)] for r in rids],
                replicas=sorted({fe.replica_of(r) for r in rids}),
                hits_migrated=rep["prefix_hits_migrated"],
                migrations=rep["interconnect"]["migrations"],
                migration_bytes=rep["interconnect"]["migration_bytes"],
                receiver_skipped=fe.engines[1 - home].prefill_tokens_skipped,
                snapshot_kinds=sorted({n.payload.kind for e in fe.engines
                                       for n in e.kv.radix.nodes()
                                       if getattr(n.payload, "live", False)}),
                sums_match=fleet_sums_match(rep), digest=fe.trace.digest(),
                launches=launches)
            entry = FLEET_MODES.get(arch)
            if entry:
                by_entry[entry] = (by_entry.get(entry, 0)
                                   + launches["ragged_paged_attention"])
            for name in ("ssd_scan", "flash_attention_fwd"):
                by_entry[name] = by_entry.get(name, 0) + launches[name]
            del fe
        cold = engine(cfg, full, params, paged, prefix_caching=False)
        for pr in prompts:
            cold.submit(list(pr), 6)
            cold.run_until_idle()
        cold_tokens = [[int(t) for t in cold.outputs[i]] for i in range(len(prompts))]
        lk, ev = runs["lockstep"], runs["event"]
        kinds = {"ragged_paged_attention": arch in FLEET_MODES,
                 "ssd_scan": arch in ("mamba2-2.7b", "hymba-1.5b"),
                 "flash_attention_fwd": not paged and arch in ("deepseek-7b",
                                                               "hymba-1.5b")}
        checks[arch] = {
            "migrated_hit": all(r["hits_migrated"] >= 1 for r in runs.values()),
            "receiver_skipped": all(r["receiver_skipped"] > 0 for r in runs.values()),
            "crossed_replicas": all(r["replicas"] == [0, 1] for r in runs.values()),
            "tokens_equal_cold": lk["tokens"] == cold_tokens,
            "lockstep_equals_event": lk["tokens"] == ev["tokens"],
            "report_sums": lk["sums_match"] and ev["sums_match"],
            "kernels_launched": all(r["launches"][k] > 0 for r in runs.values()
                                    for k, on in kinds.items() if on),
        }
        results[arch] = {"engine": "paged" if paged else "ring", **{
            c: {k: v for k, v in r.items() if k != "tokens"} for c, r in runs.items()}}
        del cold, params
        gc.collect()
    emit("reduced_fleet", dtype="float32", page_tokens=16, chunk_tokens=16,
         migrate_load_gap=-1, runs=results, launches=by_entry, checks=checks)
    _require("reduced fleet", {f"{a}.{k}": ok for a, c in checks.items()
                               for k, ok in c.items()})
    return by_entry


def drive_fleet(torch, serve, args, cfg, full, params, prompts, rpa, kernels,
                clock, profiled=True):
    """Two qwen3-8b engines on ``params`` (one draw) behind the launcher's
    ``build_cluster`` under ``clock``, on ``prompts`` as the serve phase
    drives them (the first alone, publishing the head, then the rest, 16
    new tokens each, session keys as the launcher gives them), under the
    profiler for the idle share unless ``profiled`` is False. Each
    replica's ragged-paged-attention launches are the wrapper's count's
    growth over that replica's model calls, read from zero. Returns
    (stats, tokens)."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    args.clock = clock
    engines = [serve.build_engine(args, cfg, full, params, device="cuda")
               for _ in range(2)]
    per_replica, decode_s, finite = [0, 0], [0.0], []
    for i, eng in enumerate(engines):
        eng.ecfg.eos_token = -1     # random weights may emit the default eos
        b = eng.backend

        def counted(fn, i=i, decode=False):
            def run(*a, **kw):
                n0, t = rpa.launches, time.perf_counter()
                out = fn(*a, **kw)          # ends in a host copy: synchronous
                if decode:
                    decode_s[0] += time.perf_counter() - t
                per_replica[i] += rpa.launches - n0
                return out
            return run

        def checked_sample(logits, sample=b.sample):
            finite.append(bool(torch.isfinite(logits).all()))
            return sample(logits)

        b.run_prefill_chunk = counted(b.run_prefill_chunk)
        b.run_decode = counted(b.run_decode, decode=True)
        b.sample = checked_sample
    shared = all(e.params is params and e.backend.params is params for e in engines)
    fe = serve.build_cluster(args, engines)
    # the default gap of 2 never fires on 8 requests over two replicas
    fe.migrate_load_gap = -1
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        rids = [fe.submit(prompts[0], max_new_tokens=args.max_new,
                          session_key="session-0")]
        fe.run_until_idle()
        for i, pr in enumerate(prompts[1:], 1):
            rids.append(fe.submit(pr, max_new_tokens=args.max_new,
                                  session_key=f"session-{i % args.sessions}"))
        rep = fe.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
    busy = device_busy_s(torch, prof) if profiled else None
    inter = rep["interconnect"]
    decode_tokens = rep["tokens_generated"] - rep["finished"]
    stats = dict(
        clock=clock, wall_s=wall_s, decode_s=decode_s[0], decode_tokens=decode_tokens,
        fleet_decode_tokens_per_s=decode_tokens / decode_s[0],
        tokens_per_s=rep["tokens_generated"] / wall_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        device_busy_s=busy, device_idle_share=None if busy is None else 1 - busy / wall_s,
        finished=rep["finished"], tokens_generated=rep["tokens_generated"],
        replicas_used=sorted({fe.replica_of(r) for r in rids}),
        migrations=inter["migrations"], migration_bytes=inter["migration_bytes"],
        migration_s=inter["migration_s"], migrated_tokens=inter["migrated_tokens"],
        prefix_hits_migrated=rep["prefix_hits_migrated"],
        prefill_tokens_skipped=rep["prefill_tokens_skipped"],
        trace_digest=rep["trace"]["digest"], trace_events=rep["trace"]["n_events"],
        rpa_launches_by_replica=per_replica, kernel_launches=launches,
        weights_shared=shared,
        sums_match=fleet_sums_match(rep), finite_logits=bool(finite) and all(finite))
    tokens = [[int(t) for t in fe.output(r)] for r in rids]
    del fe, engines
    gc.collect()
    torch.cuda.empty_cache()
    return stats, tokens


def fleet_serve_phase(torch, serve, param, kernels, smi, held):
    """qwen3-8b at full width and depth on the ``serve`` phase's weights
    (``held``: no second draw), two replicas behind the launcher's cluster
    frontend with ``--migrate-prefixes``, the serve defaults' traffic,
    under the lockstep clock and the event clock (each under the profiler,
    then lockstep again without it): migrations happen (the load gap forced
    to -1), ragged paged attention launched in both replicas in every run,
    every request finished with finite logits.
    Recorded, not held: the share of event tokens equal to lockstep tokens
    (bf16 ties part them, ROADMAP §C.4). Then one engine on the same
    weights and prompts with ``inject_rber=1e-3`` and the ``domain`` ECC
    profile, driven as the serve phase drives it: its pages were visited,
    its wall time beside the clean run's. Returns the fleets' and the
    injected run's launch counts."""
    rpa = kernels[0]
    cfg, full, params, prompts = (held["cfg"], held["full"], held["params"],
                                  held["prompts"])
    weight_bytes = sum(t.numel() * t.element_size() for t in param.tree_leaves(params))
    args = serve.parser().parse_args(["--arch", "qwen3-8b", "--replicas", "2",
                                      "--migrate-prefixes"])
    runs, tokens = {}, {}
    for clock in ("lockstep", "event"):
        runs[clock], tokens[clock] = drive_fleet(torch, serve, args, cfg, full, params,
                                                 prompts, rpa, kernels, clock)
    # the profiler's own cost, beside the single engine's unprofiled run
    runs["lockstep_unprofiled"], _ = drive_fleet(torch, serve, args, cfg, full, params,
                                                 prompts, rpa, kernels, "lockstep",
                                                 profiled=False)
    same = sum(a == b for x, y in zip(tokens["lockstep"], tokens["event"])
               for a, b in zip(x, y))
    event_equal_share = same / sum(map(len, tokens["event"]))
    # one engine, the same traffic, faults injected into its live pages
    args = serve.parser().parse_args(["--arch", "qwen3-8b", "--inject-rber", "1e-3",
                                      "--ecc-profile", "domain"])
    eng = serve.build_engine(args, cfg, full, params, device="cuda")
    eng.ecfg.eos_token = -1
    gc.collect()
    torch.cuda.empty_cache()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    eng.submit(prompts[0], max_new_tokens=args.max_new)
    eng.run_until_idle()
    for pr in prompts[1:]:
        eng.submit(pr, max_new_tokens=args.max_new)
    rep = eng.run_until_idle()
    torch.cuda.synchronize()
    inject_wall = time.perf_counter() - t0
    inject_launches = {fn.__name__: fn.launches for fn in kernels}
    inj = rep["reliability"]["injection"]
    same = sum(a == b for k, v in eng.outputs.items()
               for a, b in zip(v, held["tokens"][k]))
    injected = dict(inject_rber=1e-3, ecc_profile="domain", wall_s=inject_wall,
                    clean_wall_s=held["wall_s"], injection=inj,
                    finished=rep["finished"], tokens_generated=rep["tokens_generated"],
                    tokens_equal_clean_share=same / max(rep["tokens_generated"], 1),
                    kernel_launches=inject_launches)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    checks = {
        **{f"{c}.{k}": ok for c, r in runs.items() for k, ok in {
            "finished": r["finished"] == 8,
            "tokens_generated": r["tokens_generated"] == 8 * 16,
            "finite_logits": r["finite_logits"],
            "migrations": r["migrations"] >= 1 and r["migration_bytes"] > 0,
            "both_replicas_served": r["replicas_used"] == [0, 1],
            # one weight draw: no replica copied it (peak within 10% of it)
            "one_weight_copy": r["weights_shared"]
            and r["peak_mem_bytes"] < 1.1 * weight_bytes,
            "rpa_in_both_replicas": all(n > 0 for n in r["rpa_launches_by_replica"])
            and sum(r["rpa_launches_by_replica"])
            == r["kernel_launches"]["ragged_paged_attention"],
            "report_sums": r["sums_match"]}.items()},
        "event_trace": runs["event"]["trace_events"] > 0,
        "inject_pages_visited": inj["pages_visited"] > 0,
        "inject_finished": rep["finished"] == 8,
    }
    emit("fleet_serve", nvidia_smi=smi, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, replicas=2, migrate_load_gap=-1,
         runs=runs, event_tokens_equal_lockstep_share=event_equal_share,
         injected=injected, checks=checks)
    _require("fleet serve", checks)
    return ({c: runs[c]["kernel_launches"] for c in ("lockstep", "event")},
            inject_launches)


OVERRIDE_FLAGS = ["--kernel-block-kv", "4", "--kernel-buffers", "3"]


def serve_overrides_phase(torch, serve, tune, kernels, smi, held):
    """qwen3-8b at full width and depth on the ``serve`` phase's weights
    (``held``: no second draw) through the launcher's flags
    ``OVERRIDE_FLAGS``, which the engine pins in ``tune.py``'s cache for its
    page geometry; the serve phase's traffic, driven as it drives it. Held:
    the memory-plane report equals the default run's, and so does the
    paged kernel's launch count; every request finished. Recorded, not
    held: the share of tokens equal to the default run's (bf16 ties may
    part them, ROADMAP §C.4). The pinned plan is dropped after the run.
    Returns the run's launch counts."""
    cfg, full, params, prompts = (held["cfg"], held["full"], held["params"],
                                  held["prompts"])
    args = serve.parser().parse_args(["--arch", "qwen3-8b", *OVERRIDE_FLAGS])
    saved = dict(tune._CACHE)
    try:
        eng = serve.build_engine(args, cfg, full, params, device="cuda")
        eng.ecfg.eos_token = -1      # as the serve phase: random weights may emit it
        plan = tune.best_config(args.page_tokens, cfg.resolved_head_dim)
        gc.collect()
        torch.cuda.empty_cache()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        eng.submit(prompts[0], max_new_tokens=args.max_new)
        eng.run_until_idle()
        for pr in prompts[1:]:
            eng.submit(pr, max_new_tokens=args.max_new)
        rep = eng.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        same = sum(a == b for k, v in eng.outputs.items()
                   for a, b in zip(v, held["tokens"][k]))
        del eng
    finally:
        tune._CACHE.clear()
        tune._CACHE.update(saved)
    gc.collect()
    torch.cuda.empty_cache()
    checks = {"plan_pinned": plan == tune.KernelConfig(16, 4, 3),
              "report_equals_default": json.dumps(rep, sort_keys=True, default=float)
              == json.dumps(held["report"], sort_keys=True, default=float),
              "launches_equal_default": launches["ragged_paged_attention"]
              == held["launches"]["ragged_paged_attention"] > 0,
              "finished": rep["finished"] == 8}
    emit("serve_overrides", nvidia_smi=smi, arch=cfg.name, layers=cfg.num_layers,
         flags=OVERRIDE_FLAGS, plan=[plan.block_q, plan.block_kv, plan.num_buffers],
         wall_s=wall_s, default_wall_s=held["wall_s"], kernel_launches=launches,
         tokens_equal_default_share=same / max(rep["tokens_generated"], 1), checks=checks)
    _require("serve overrides", checks)
    return launches


def examples_phase(torch, smi):
    """The example legs on the card, each as ``python <leg>`` would run it
    (in this process): ``examples/quickstart_torch.py`` (reduced qwen3-8b
    serving, prefix reuse, the reliability plane),
    ``examples/serve_batched_mrm_torch.py`` (reduced gemma2-27b serving,
    metered at full size) and ``examples/train_tiny_lm_torch.py`` at 40
    steps and its 60-step resume (reduced deepseek-7b; at 6 steps of the
    40-step warmup the loss, on a new batch each step, need not fall).
    Each leg's own asserts must hold; their printed lines are recorded."""
    import contextlib
    import io
    import runpy
    import tempfile
    printed, seconds = {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        for leg, argv in (("quickstart_torch", []), ("serve_batched_mrm_torch", []),
                          ("train_tiny_lm_torch", ["--steps", "40", "--ckpt-dir", ckpt])):
            path = ROOT / "examples" / f"{leg}.py"
            argv0 = sys.argv
            sys.argv = [str(path), *argv]
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    runpy.run_path(str(path), run_name="__main__")
            finally:
                sys.argv = argv0
            torch.cuda.synchronize()
            seconds[leg] = time.perf_counter() - t0
            printed[leg] = buf.getvalue().splitlines()
            gc.collect()
            torch.cuda.empty_cache()
    emit("examples", nvidia_smi=smi, seconds=seconds, printed=printed,
         checks={leg: True for leg in printed})


RELIABILITY_ARMS = {"clean": (None, True, 0.8), "protected": (1e-3, True, 0.8),
                    "overaged": (1e-3, False, 8.0)}   # (rber, refresh, jump / deadline)


def reliability_phase(torch, cfg_mod, tfm, param, kernels):
    """The three arms of ``benchmarks/serving_sim.py::reliability`` through
    the port, on reduced fp32 deepseek-7b (page and chunk 16, no tail copy,
    the domain ECC profile, sessions of 600 s): clean; protected (RBER
    1e-3 at retention, the clock jumped to 80% of the refresh deadline
    after the first decode tokens, so scrub-on-read fires); over-aged
    (refresh servicing off, the clock jumped past 4x retention). Its gates:
    protected tokens match the clean run's on >= 95%, with no
    uncorrectable block and scrubbed pages; the over-aged arm reports
    uncorrectable blocks and matches below the protected arm and at most
    90%. Each arm runs on CUDA (the kernels, flips XORed into the pages on
    the card) and on the CPU (the plain versions), same weights: its
    injection counters must be equal, since the draws come from one numpy
    generator and the page visits follow the schedule, not the values.
    Returns the CUDA arms' launches."""
    import numpy as np
    from repro_torch.core.memclass import HBM3E, MRM_RRAM
    from repro_torch.core.simulator import MemorySystem
    from repro_torch.serving import EngineConfig, ServeEngine
    full = cfg_mod.get_config("deepseek-7b")
    cfg = cfg_mod.reduced(full, dtype="float32", param_dtype="float32")
    cpu_params = tfm.init_params(cfg, 0, device="cpu")
    weights = {"cpu": cpu_params,
               "cuda": param.tree_map(lambda a: a.to("cuda"), cpu_params)}
    rng = np.random.default_rng(0)
    head = [int(x) for x in rng.integers(2, cfg.vocab_size, 32)]
    prompts = [head + [int(x) for x in rng.integers(2, cfg.vocab_size, 8)]
               for _ in range(3)]
    session_s = 600.0
    deadline_s = 2.0 * session_s / 2.0      # retention 2x session, deadline half

    def run_arm(arm, dev):
        rber, refresh, jump = RELIABILITY_ARMS[arm]
        mem = MemorySystem({"mrm": (MRM_RRAM, 1 << 40), "hbm": (HBM3E, 1 << 37)},
                           ecc_profile="domain", service_refresh=refresh)
        eng = ServeEngine(cfg, weights[dev], mem,
                          EngineConfig(max_slots=2, max_cache_len=96, weight_tier="hbm",
                                       kv_tier="mrm", eos_token=-1, chunk_tokens=16,
                                       page_tokens=16, tail_copy=False, paged_kernel=True,
                                       expected_session_s=session_s, inject_rber=rber,
                                       inject_seed=0),
                          account_cfg=full, device=dev)
        for pr in prompts:
            eng.submit(list(pr), 6)
        steps = 0
        while not eng.sched.idle and eng.tokens_generated < 2 and steps < 500:
            eng.step()
            steps += 1
        eng.mem.advance(jump * deadline_s)
        rep = eng.run_until_idle()
        return (eng.kv.lifecycle.stats.scrubbed_pages, rep["reliability"],
                {k: [int(t) for t in v] for k, v in eng.outputs.items()})

    def match(a, b):
        total = hits = 0
        for k, toks in a.items():
            other = b.get(k, [])
            total += max(len(toks), len(other))
            hits += sum(x == y for x, y in zip(toks, other))
        return hits / max(total, 1)

    arms, launches = {}, {}
    for arm in RELIABILITY_ARMS:
        for fn in kernels:
            fn.launches = 0
        arms[arm] = {"cuda": run_arm(arm, "cuda")}
        launches[arm] = {fn.__name__: fn.launches for fn in kernels}
        arms[arm]["cpu"] = run_arm(arm, "cpu")
    clean = arms["clean"]["cuda"][2]
    (p_scrub, p_rel, p_out), (_, o_rel, o_out) = (arms["protected"]["cuda"],
                                                  arms["overaged"]["cuda"])
    prot_match, over_match = match(clean, p_out), match(clean, o_out)
    checks = {
        "protected_match": prot_match >= 0.95,
        "protected_no_uncorrectable": p_rel["injection"]["uncorrectable_blocks"] == 0,
        "protected_scrubbed": p_scrub > 0
        and p_rel["tiers"]["mrm"]["scrub_read_bytes"] > 0,
        "overaged_uncorrectable": o_rel["injection"]["uncorrectable_blocks"] > 0,
        "overaged_degrades": over_match < prot_match and over_match <= 0.9,
        **{f"{arm}.injection_cuda_equals_cpu":
           a["cuda"][1].get("injection") == a["cpu"][1].get("injection")
           and a["cuda"][0] == a["cpu"][0] for arm, a in arms.items()},
        "paged_kernel_launched": all(n["ragged_paged_attention"] > 0
                                     for n in launches.values()),
    }
    emit("reliability", arch=cfg.name, dtype="float32", inject_rber=1e-3,
         protected_match=prot_match, overaged_match=over_match,
         cpu_protected_match=match(arms["clean"]["cpu"][2], arms["protected"]["cpu"][2]),
         cpu_overaged_match=match(arms["clean"]["cpu"][2], arms["overaged"]["cpu"][2]),
         arms={arm: {"scrubbed_pages": a["cuda"][0],
                     "injection": a["cuda"][1].get("injection"),
                     "cpu_injection": a["cpu"][1].get("injection"),
                     "tokens_equal_cpu_share": match(a["cpu"][2], a["cuda"][2])}
               for arm, a in arms.items()},
         launches=launches, checks=checks)
    _require("reliability", checks)
    return sum(n["ragged_paged_attention"] for n in launches.values())


TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)


def conditioned(tree, d_model, names=("wq", "wk")):
    """``tree`` with every leaf named in ``names`` (the score-setting
    leaves: wq and wk; for MLA also w_uk, k_nope = c W_uk) rescaled to std
    d_model^-1/2. The reference's fan-in rule gives gemma-2b's single KV
    head wk std 1 (and MLA's wq and w_uk, fanned in over their 16 heads,
    std 0.25), so attention scores saturate; there fp32 gradients are
    ill-conditioned and two sound implementations (the same function
    summed in another order) part after Adam's first step. With scores of
    std ~1 they agree to ~1e-6."""
    if isinstance(tree, dict):
        return {k: v * (d_model ** -0.5 / float(v.float().std()))
                if k in names else conditioned(v, d_model, names)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(conditioned(v, d_model, names) for v in tree)
    return tree


def reduced_train_phase(torch, cfg_mod, tfm, param, optim, train, data, ckpt):
    """Reduced gemma-2b (head_dim 256, fp32, conditioned wq/wk): three AdamW
    steps on CUDA (the flash kernels) against the CPU (the plain versions),
    same weights and batches, losses and grad norms within 1e-4 relative
    (the tolerance of tests/test_torch_train.py against JAX); then on CUDA,
    a checkpoint after step 2 restored into fresh tensors continues steps
    2-3 with the losses of the run that saved it."""
    import math
    import tempfile
    cfg = cfg_mod.reduced(cfg_mod.get_config("gemma-2b"), dtype="float32",
                          param_dtype="float32", head_dim=256)
    weights = conditioned(tfm.init_params(cfg, 0, device="cpu"), cfg.d_model)
    pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=128, global_batch=2,
                                                       seed=3))
    batches = [pipe.batch_at(s) for s in range(4)]
    oc = optim.OptConfig(**TRAIN_OPT)

    def run(dev, steps, state=None, start=0, save_to=None):
        if state is None:
            p = param.tree_map(lambda a: a.to(dev, copy=True), weights)
            state = (p, optim.init_opt_state(p))
        p, o = state
        step = train.make_train_step(cfg, oc)
        out = []
        for s in range(start, steps):
            p, o, m = step(p, o, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batches[s].items()})
            out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            if save_to is not None and s == 1:
                ckpt.save(save_to, 2, (p, o), extra={"step": 2})
        return out

    cuda, cpu = run("cuda", 3), run("cpu", 3)
    rows = []
    for s in range(3):
        for key in ("loss", "grad_norm"):
            want = cpu[s][key]
            rel = abs(cuda[s][key] - want) / abs(want)
            rows.append({"step": s, "metric": key, "cuda": cuda[s][key],
                         "cpu": want, "rel_err": rel})
            if not (rel <= 1e-4 and math.isfinite(cuda[s][key])):
                raise AssertionError(f"reduced train on CUDA vs CPU: {rows[-1]}")

    with tempfile.TemporaryDirectory() as d:
        saved = run("cuda", 4, save_to=d)
        fresh = tfm.init_params(cfg, 1, device="cuda")
        state, extra = ckpt.restore(d, 2, (fresh, optim.init_opt_state(fresh)))
        resumed = run("cuda", 4, state=state, start=extra["step"])
    resume_err = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                  for a, b in zip(resumed, saved[2:])]
    if not (len(resumed) == 2 and max(resume_err) <= 1e-5):
        raise AssertionError(f"resumed losses {resumed} vs {saved[2:]}")
    emit("reduced_train_check", arch="gemma-2b", head_dim=256, dtype="float32",
         steps=rows, tolerance="1e-4 relative",
         resume_relative_loss_err=resume_err, resume_tolerance=1e-5)


def full_width_grad_phase(torch, cfg_mod, tfm, param, optim, train, data, fops, fref):
    """gemma-2b at full width, 3 layers, fp32, one batch of 1 x 512 tokens:
    loss and gradients through the flash kernels (CUDA) against the plain
    versions (CPU), at the reference's initialisation and with conditioned
    wq/wk. With conditioned weights CUDA must agree with the CPU within
    1e-5 relative in the loss, 1e-4 relative in the grad norm and 1e-4 of
    each leaf's largest |grad| (the tolerances of
    tests/test_torch_train.py). Recorded, not held, for each
    initialisation: the plain versions against themselves with every
    weight moved by about half an fp32 ulp (how far two sound fp32 runs
    may part), and attention alone at that initialisation's q/k/v scales
    (B 1, S 512, H 8, Hkv 1, D 256): the kernels and the plain versions in
    fp32, each against the plain versions in float64."""
    import dataclasses
    cfg = dataclasses.replace(cfg_mod.get_config("gemma-2b"), num_layers=3,
                              dtype="float32", param_dtype="float32")
    pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=512, global_batch=1,
                                                       seed=0))
    batch = pipe.batch_at(0)
    # the same bits on either device; the card draws 1.2 G elements faster
    base = param.tree_map(lambda a: a.cpu(), tfm.init_params(cfg, 0, device="cuda"))

    def grads(w, dev):
        t0 = time.perf_counter()
        loss, _, g = train.step.value_and_grad(
            cfg, param.tree_map(lambda a: a.to(dev), w) if dev == "cuda" else w,
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        g = [x.cpu() for x in param.tree_leaves(g)]
        return {"loss": float(loss), "grad_norm": float(optim.global_norm(g)),
                "leaves": g, "s": time.perf_counter() - t0}

    def rel(x, y):
        return float((x.double() - y.double()).abs().max() / y.double().abs().max())

    def diff(a, b):
        return {"loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
                "leaf_rel_max": max(rel(x, y) for x, y in zip(a["leaves"], b["leaves"]))}

    def half_ulp(w):
        g = torch.Generator().manual_seed(1)
        return param.tree_map(lambda a: (a.double() * (1 + 2.0 ** -24 * torch.randn(
            a.shape, generator=g, dtype=torch.float64))).float(), w)

    def first(tree, key):
        if isinstance(tree, dict):
            if key in tree:
                return tree[key]
            tree = list(tree.values())
        if isinstance(tree, (tuple, list)):
            found = [first(t, key) for t in tree]
            return next((f for f in found if f is not None), None)
        return None

    def attention_alone(w):
        """(kernels, plain) fp32 errors against float64, out/dq/dk/dv."""
        g = torch.Generator(device="cuda").manual_seed(0)
        std = {n: cfg.d_model ** 0.5 * float(first(w, n).std()) for n in ("wq", "wk", "wv")}
        shapes = {"wq": (1, 512, 8, 256), "wk": (1, 512, 1, 256), "wv": (1, 512, 1, 256)}
        x = [torch.randn(shapes[n], generator=g, device="cuda", dtype=torch.float64)
             * std[n] for n in ("wq", "wk", "wv")]
        do = torch.randn(shapes["wq"], generator=g, device="cuda", dtype=torch.float64)
        kw = dict(scale=256 ** -0.5, cap=None, window=None)

        def plain(q, k, v, dout):
            out, m, l = fref.flash_fwd_ref(q, k, v, **kw)
            delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
            return (out, *fref.flash_bwd_ref(q, k, v, m, l, dout, delta, **kw))

        def kernels(q, k, v, dout):
            out, m, l = fops.flash_attention_fwd(q, k, v, **kw)
            return (out, *fops.flash_attention_bwd(q, k, v, out, m, l, dout, **kw))

        truth = plain(*x, do)
        f32 = [t.float().contiguous() for t in (*x, do)]
        return {"score_std": std["wq"] * std["wk"],
                **{name: dict(zip(("out", "dq", "dk", "dv"),
                                  (rel(a, b) for a, b in zip(fn(*f32), truth))))
                   for name, fn in (("kernels_vs_f64", kernels), ("plain_vs_f64", plain))}}

    readings = {}
    for init, w in (("reference", base), ("conditioned", conditioned(base, cfg.d_model))):
        kern, plain, nudged = grads(w, "cuda"), grads(w, "cpu"), grads(half_ulp(w), "cpu")
        torch.cuda.empty_cache()
        readings[init] = {
            "kernels": {k: kern[k] for k in ("loss", "grad_norm", "s")},
            "plain": {k: plain[k] for k in ("loss", "grad_norm", "s")},
            "plain_half_ulp": {k: nudged[k] for k in ("loss", "grad_norm", "s")},
            "kernels_vs_plain": diff(kern, plain),
            "half_ulp_vs_plain": diff(nudged, plain),
            "attention_alone": attention_alone(w)}
    kvp = readings["conditioned"]["kernels_vs_plain"]
    checks = {"loss": kvp["loss_rel"] <= 1e-5, "grad_norm": kvp["grad_norm_rel"] <= 1e-4,
              "leaves": kvp["leaf_rel_max"] <= 1e-4}
    emit("full_width_grad_check", arch="gemma-2b", layers=cfg.num_layers,
         d_model=cfg.d_model, head_dim=cfg.resolved_head_dim, vocab=cfg.vocab_size,
         dtype=cfg.dtype, batch=1, seq_len=512, readings=readings, checks=checks)
    _require("full-width gemma-2b gradients, kernels vs plain", checks)


def reduced_train_multiarch_phase(torch, cfg_mod, tfm, param, optim, train, data,
                                  frontends, fops):
    """Reduced fp32 mixtral-8x22b (8 experts top-2, window 64: the MoE aux
    loss), musicgen-large (4 codebooks: the pipeline's (B, S, 4) batches)
    and internvl2-76b (8 patch embeddings in front, from ``sample_batch``),
    wq/wk conditioned: three AdamW steps on CUDA (the flash kernels at D 32,
    group 1) against the CPU (the plain versions), same weights and
    batches, losses and grad norms within 1e-4 relative (the tolerance of
    the CPU tests against JAX); every attention layer of every CUDA step
    launched the flash forward twice (forward and recompute) and each
    backward kernel once. Reduced deepseek-v2-lite's MLA heads (Dk 48, Dv
    32) have no instantiation: its card check is ``mla_grad_phase``."""
    import math
    oc = optim.OptConfig(**TRAIN_OPT)
    flash = (fops.flash_attention_fwd, fops.flash_attention_bwd_dkdv,
             fops.flash_attention_bwd_dq)
    for arch in ("mixtral-8x22b", "musicgen-large", "internvl2-76b"):
        kw = {"n_experts": 8} if arch == "mixtral-8x22b" else {}
        cfg = cfg_mod.reduced(cfg_mod.get_config(arch), dtype="float32",
                              param_dtype="float32", **kw)
        weights = conditioned(tfm.init_params(cfg, 0, device="cpu"), cfg.d_model)
        if cfg.frontend == "vision":
            batches = [frontends.sample_batch(cfg, 2, 64 + cfg.n_frontend_tokens, seed=s)
                       for s in range(3)]
        else:
            pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=64, global_batch=2,
                                                               seed=3))
            batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
                       for s in range(3)]

        def run(dev):
            p = param.tree_map(lambda a: a.to(dev, copy=True), weights)
            o = optim.init_opt_state(p)
            step = train.make_train_step(cfg, oc)
            res = []
            for b in batches:
                p, o, m = step(p, o, {k: v.to(dev) for k, v in b.items()})
                res.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
            return res

        for fn in flash:
            fn.launches = 0
        cuda = run("cuda")
        launches = {fn.__name__: fn.launches for fn in flash}
        cpu = run("cpu")
        rows = [{"step": s, "metric": key, "cuda": cuda[s][key], "cpu": cpu[s][key],
                 "rel_err": abs(cuda[s][key] - cpu[s][key]) / abs(cpu[s][key])}
                for s in range(3) for key in ("loss", "grad_norm")]
        L = cfg.num_layers
        checks = {"within_1e-4": all(r["rel_err"] <= 1e-4 and math.isfinite(r["cuda"])
                                     for r in rows),
                  "aux": all((c["aux"] > 0) == (cfg.n_experts > 0) for c in cuda),
                  "fwd_launches": launches["flash_attention_fwd"] == 2 * L * 3,
                  "dkdv_launches": launches["flash_attention_bwd_dkdv"] == L * 3,
                  "dq_launches": launches["flash_attention_bwd_dq"] == L * 3}
        emit("reduced_train_check", arch=arch, head_dim=cfg.resolved_head_dim,
             heads=[cfg.n_heads, cfg.n_kv_heads], codebooks=cfg.n_codebooks,
             image_embeds=cfg.n_frontend_tokens if cfg.frontend == "vision" else 0,
             dtype="float32", steps=rows, aux=[c["aux"] for c in cuda],
             tolerance="1e-4 relative", launches=launches, checks=checks)
        _require(f"reduced {arch} train, CUDA vs CPU", checks)


def mla_grad_phase(torch, cfg_mod, tfm, param, optim, train, data, fops):
    """deepseek-v2-lite-16b at full width, 2 layers (the dense layer and one
    MoE layer: MLA at Dk 192 / Dv 128 on 16/16 heads, 64 experts top-6 and 2
    shared), fp32, one batch of 1 x 512 tokens: the loss (ce, z_loss and
    aux each), the grad norm and every gradient leaf through the flash
    kernels' Dk != Dv mode (CUDA) against the plain versions (CPU), same
    weights, with the score-setting leaves wq and w_uk conditioned (see
    ``conditioned``); the limits of ``full_width_grad_phase``: 1e-5
    relative in the loss terms, 1e-4 in the grad norm and 1e-4 of each
    leaf's largest |grad|. Every layer launched the forward kernel twice
    (forward and remat recompute) and each backward kernel once."""
    import dataclasses
    cfg = dataclasses.replace(cfg_mod.get_config("deepseek-v2-lite-16b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=512, global_batch=1,
                                                       seed=0))
    batch = pipe.batch_at(0)
    base = conditioned(param.tree_map(lambda a: a.cpu(), tfm.init_params(cfg, 0,
                                                                        device="cuda")),
                       cfg.d_model, names=("wq", "w_uk"))

    def grads(dev):
        t0 = time.perf_counter()
        loss, metrics, g = train.step.value_and_grad(
            cfg, param.tree_map(lambda a: a.to(dev), base),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        g = [x.cpu() for x in param.tree_leaves(g)]
        return {"loss": float(loss), **{k: float(metrics[k]) for k in ("ce", "z_loss", "aux")},
                "grad_norm": float(optim.global_norm(g)), "leaves": g,
                "s": time.perf_counter() - t0}

    flash = (fops.flash_attention_fwd, fops.flash_attention_bwd_dkdv,
             fops.flash_attention_bwd_dq)
    for fn in flash:
        fn.launches = 0
    kern = grads("cuda")
    launches = {fn.__name__: fn.launches for fn in flash}
    plain = grads("cpu")
    torch.cuda.empty_cache()
    leaf_rel = [float((x.double() - y.double()).abs().max() / y.double().abs().max())
                for x, y in zip(kern["leaves"], plain["leaves"])]
    res = {f"{k}_rel": abs(kern[k] - plain[k]) / abs(plain[k])
           for k in ("loss", "ce", "z_loss", "aux", "grad_norm")}
    res["leaf_rel_max"] = max(leaf_rel)
    L = cfg.num_layers
    checks = {"loss": all(res[f"{k}_rel"] <= 1e-5 for k in ("loss", "ce", "z_loss", "aux")),
              "grad_norm": res["grad_norm_rel"] <= 1e-4,
              "leaves": res["leaf_rel_max"] <= 1e-4,
              "aux_positive": kern["aux"] > 0,
              "every_leaf_reached": all(float(y.abs().max()) > 0 for y in plain["leaves"]),
              "fwd_launches": launches["flash_attention_fwd"] == 2 * L,
              "dkdv_launches": launches["flash_attention_bwd_dkdv"] == L,
              "dq_launches": launches["flash_attention_bwd_dq"] == L}
    emit("mla_grad_check", arch=cfg.name, layers=L, d_model=cfg.d_model,
         mla=[cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim],
         experts=[cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts],
         vocab=cfg.vocab_size, dtype=cfg.dtype, batch=1, seq_len=512,
         conditioned=["wq", "w_uk"],
         kernels={k: kern[k] for k in ("loss", "ce", "z_loss", "aux", "grad_norm", "s")},
         plain={k: plain[k] for k in ("loss", "ce", "z_loss", "aux", "grad_norm", "s")},
         kernels_vs_plain=res, leaf_rel=leaf_rel, launches=launches, checks=checks)
    _require("full-width deepseek-v2-lite gradients, kernels vs plain", checks)


def ssm_grad_phase(torch, cfg_mod, tfm, param, optim, train, data, sops):
    """mamba2-2.7b at full width, 2 layers, fp32, one batch of 1 x 512
    tokens: the loss and every gradient leaf through the SSD kernels, the
    forward and the backward (CUDA), against the plain versions (CPU), same
    weights: 1e-5 relative in the loss, 1e-4 relative in the grad norm and
    1e-4 of each leaf's largest |grad| (the tolerances of
    tests/test_torch_train_ssm.py). mamba2 is well conditioned at the
    reference's initialisation (no attention): no rescaling. Every layer
    launched the forward kernel twice (forward and remat recompute) and the
    backward once."""
    import dataclasses
    cfg = dataclasses.replace(cfg_mod.get_config("mamba2-2.7b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=512, global_batch=1,
                                                       seed=0))
    batch = pipe.batch_at(0)
    base = param.tree_map(lambda a: a.cpu(), tfm.init_params(cfg, 0, device="cuda"))

    def grads(dev):
        t0 = time.perf_counter()
        loss, _, g = train.step.value_and_grad(
            cfg, param.tree_map(lambda a: a.to(dev), base),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        g = [x.cpu() for x in param.tree_leaves(g)]
        return {"loss": float(loss), "grad_norm": float(optim.global_norm(g)),
                "leaves": g, "s": time.perf_counter() - t0}

    sops.ssd_scan.launches = sops.ssd_scan_bwd.launches = 0
    kern = grads("cuda")
    launches = {"ssd_scan": sops.ssd_scan.launches,
                "ssd_scan_bwd": sops.ssd_scan_bwd.launches}
    plain = grads("cpu")
    torch.cuda.empty_cache()
    leaf_rel = [float((x.double() - y.double()).abs().max() / y.double().abs().max())
                for x, y in zip(kern["leaves"], plain["leaves"])]
    res = {"loss_rel": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
           "grad_norm_rel": abs(kern["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"],
           "leaf_rel_max": max(leaf_rel)}
    checks = {"loss": res["loss_rel"] <= 1e-5, "grad_norm": res["grad_norm_rel"] <= 1e-4,
              "leaves": res["leaf_rel_max"] <= 1e-4,
              "every_leaf_reached": all(float(y.abs().max()) > 0 for y in plain["leaves"]),
              "fwd_launches": launches["ssd_scan"] == 2 * cfg.num_layers,
              "bwd_launches": launches["ssd_scan_bwd"] == cfg.num_layers}
    emit("ssm_grad_check", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         ssd=[cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state], vocab=cfg.vocab_size,
         dtype=cfg.dtype, batch=1, seq_len=512,
         kernels={k: kern[k] for k in ("loss", "grad_norm", "s")},
         plain={k: plain[k] for k in ("loss", "grad_norm", "s")},
         kernels_vs_plain=res, leaf_rel=leaf_rel, launches=launches, checks=checks)
    _require("full-width mamba2 gradients, kernels vs plain", checks)


MLA_TRAIN_LAYERS = 6   # deepseek-v2-lite-16b's first 6 of 27: the dense layer, 5 MoE


def mla_train_phase(torch, cfg_mod, tfm, param, optim, train, data, kernels, smi):
    """deepseek-v2-lite-16b at full width cut to its first 6 of 27 layers
    (the dense layer and 5 MoE layers, 3.35 G parameters), bf16, 4 AdamW
    steps of 4 x 2048 tokens, ``remat="full"``, through
    ``train.step.make_train_step`` on ``dataclasses.replace(cfg,
    num_layers=6)`` (the depth cut ``run_serve`` makes). 12 B a parameter
    (bf16 weights and gradients, fp32 moments: 40.2 GB) plus AdamW's fp32
    temporaries on the (5, 64, 2048, 1408) expert leaves, the old and the
    clipped gradients (6.7 GB) and a CE chunk peak under ~72 GB. Every MLA
    layer of every step launched the flash forward twice (forward and
    recompute) at Dk 192 / Dv 128 and each backward kernel once; finite
    losses, the step-0 loss within 3 of ln(vocab), the aux loss positive.
    Returns the launches."""
    import dataclasses
    import math
    cfg = dataclasses.replace(cfg_mod.get_config("deepseek-v2-lite-16b"),
                              num_layers=MLA_TRAIN_LAYERS)
    B, S, steps = 4, 2048, 4
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, 0, device="cuda")
    opt_state = optim.init_opt_state(params)
    draw_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in param.tree_leaves(params))
    pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=S, global_batch=B, seed=0))
    step_fn = train.make_train_step(cfg, optim.OptConfig(lr=3e-4, warmup_steps=1,
                                                         total_steps=steps))
    for fn in kernels:
        fn.launches = 0
    hist = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(s).items()}
        ts = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        hist.append({"step": s, "dt_s": time.perf_counter() - ts,
                     **{k: float(m[k]) for k in ("loss", "ce", "z_loss", "aux",
                                                 "grad_norm")}})
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    del params, opt_state
    L = cfg.num_layers
    step_s = [h["dt_s"] for h in hist]
    steady_s = statistics.median(step_s[1:])
    checks = {
        "full_width": (cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim,
                       cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts, cfg.moe_top_k,
                       cfg.n_shared_experts, cfg.expert_d_ff, cfg.d_ff, cfg.vocab_size,
                       cfg.dtype)
        == (2048, 16, 512, 128, 64, 128, 64, 6, 2, 1408, 10944, 102400, "bfloat16"),
        "finite": all(math.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm")),
        "step0_loss_near_ln_vocab": abs(hist[0]["loss"] - math.log(cfg.vocab_size)) < 3.0,
        "aux_positive": all(h["aux"] > 0 for h in hist),
        "fwd_launches": launches["flash_attention_fwd"] == 2 * L * steps,
        "dkdv_launches": launches["flash_attention_bwd_dkdv"] == L * steps,
        "dq_launches": launches["flash_attention_bwd_dq"] == L * steps,
        "peak_under_72GB": peak < 72e9,
    }
    emit("mla_train", nvidia_smi=smi, arch=cfg.name, layers=L, of_layers=27,
         parameters=n_params, d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
         remat=cfg.remat, batch=B, seq_len=S, weight_draw_s=draw_s, history=hist,
         step_s=step_s, steady_step_ms=steady_s * 1e3, tokens_per_s=B * S / steady_s,
         step0_loss=hist[0]["loss"], ln_vocab=math.log(cfg.vocab_size),
         peak_mem_bytes=peak, kernel_launches=launches, checks=checks)
    _require("deepseek-v2-lite-16b train", checks)
    return launches


def launcher_train_phases(torch, cfg_mod, train_cli, kernels, smi, phases=None):
    """mamba2-2.7b (64 layers, 4 x 2048 tokens, 4 steps), hymba-1.5b (32
    layers, 2 x 2048 tokens + 128 meta, 3 steps) and musicgen-large (48
    layers, 4 codebooks of 2048, 4 x 2048 tokens, 3 steps) at full width and
    depth through ``launch/train.py``: bf16, remat "full", AdamW, no
    checkpoint. Every SSM layer of every step launched the SSD forward
    kernel twice (forward and recompute) and the backward once; every
    attention layer (hymba's attention halves, musicgen's MHA at D 64) the
    flash forward twice and the dK/dV and dQ kernels once. mamba2's and
    musicgen's step-0 losses must lie within 3 of ln(vocab); hymba's is
    recorded (at the reference's initialisation full-width hymba amplifies
    rounding to O(1), ROADMAP §C). Returns each run's launches."""
    import math
    out = {}
    runs = (("ssm_train", "mamba2-2.7b", 4, 2048, 4), ("hybrid_train", "hymba-1.5b", 2, 2048, 3),
            ("audio_train", "musicgen-large", 4, 2048, 3))
    for phase, arch, B, S, steps in runs:
        if phases is not None and phase not in phases:
            continue
        cfg = cfg_mod.get_config(arch)
        argv = ["--arch", arch, "--seq-len", str(S), "--batch", str(B),
                "--steps", str(steps), "--warmup", "1", "--remat", "full",
                "--log-every", "1"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        hist = train_cli.main(argv)
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        L = cfg.num_layers
        kinds = [s.kind for s in cfg.layer_specs()]
        n_attn = sum(k in ("attn", "hybrid") for k in kinds)
        n_ssm = sum(k in ("ssm", "hybrid") for k in kinds)
        step_s = [h["dt_s"] for h in hist]
        steady_s = statistics.median(step_s[1:])
        checks = {
            "steps_logged": [h["step"] for h in hist] == list(range(steps)),
            "finite": all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                          for h in hist),
            "ssd_fwd_launches": launches["ssd_scan"] == 2 * n_ssm * steps,
            "ssd_bwd_launches": launches["ssd_scan_bwd"] == n_ssm * steps,
            "flash_fwd_launches": launches["flash_attention_fwd"] == 2 * n_attn * steps,
            "dkdv_launches": launches["flash_attention_bwd_dkdv"] == n_attn * steps,
            "dq_launches": launches["flash_attention_bwd_dq"] == n_attn * steps,
        }
        if phase != "hybrid_train":
            checks["step0_loss_near_ln_vocab"] = (
                abs(hist[0]["loss"] - math.log(cfg.vocab_size)) < 3.0)
        if phase == "ssm_train":
            checks["full_width"] = ((L, cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim,
                                     cfg.ssm_state, cfg.vocab_size, cfg.dtype)
                                    == (64, 2560, 80, 64, 128, 50280, "bfloat16"))
        elif phase == "audio_train":
            checks["full_width"] = ((L, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, cfg.d_ff, cfg.n_codebooks,
                                     cfg.vocab_size, cfg.dtype)
                                    == (48, 2048, 32, 32, 64, 8192, 4, 2048, "bfloat16"))
        else:
            checks["full_width"] = ((L, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, cfg.ssm_nheads,
                                     cfg.ssm_state, cfg.n_meta_tokens, cfg.vocab_size,
                                     cfg.dtype)
                                    == (32, 1600, 25, 5, 64, 50, 16, 128, 32001,
                                        "bfloat16"))
        emit(phase, nvidia_smi=smi, arch=arch, layers=L, d_model=cfg.d_model,
             vocab=cfg.vocab_size, dtype=cfg.dtype, remat="full", batch=B, seq_len=S,
             meta_tokens=cfg.n_meta_tokens, history=hist, wall_s=wall_s, step_s=step_s,
             steady_step_ms=steady_s * 1e3, tokens_per_s=B * S / steady_s,
             step0_loss=hist[0]["loss"], ln_vocab=math.log(cfg.vocab_size),
             peak_mem_bytes=torch.cuda.max_memory_allocated(),
             kernel_launches=launches, checks=checks)
        _require(f"{arch} train", checks)
        out[arch] = launches
    return out


def train_phase(torch, cfg_mod, train_cli, kernels, smi):
    """gemma-2b at full width and depth through ``launch/train.py``: 4 steps
    of 4 x 2048 tokens, bf16, remat "full", no checkpoint (the state is
    30 GB). Every layer of every step launched the forward kernel twice
    (forward and recompute) and each backward kernel once."""
    import math
    cfg = cfg_mod.get_config("gemma-2b")      # nothing reduced
    B, S, steps = 4, 2048, 4
    argv = ["--arch", "gemma-2b", "--seq-len", str(S), "--batch", str(B),
            "--steps", str(steps), "--warmup", "1", "--remat", "full",
            "--log-every", "1"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    hist = train_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    L = cfg.num_layers
    step_s = [h["dt_s"] for h in hist]
    steady_s = statistics.median(step_s[1:])
    checks = {
        "full_width": (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
                       cfg.remat)
        == (18, 2048, 8, 1, 256, 16384, 256000, "bfloat16", "full"),
        "steps_logged": [h["step"] for h in hist] == list(range(steps)),
        "finite": all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                      for h in hist),
        "step0_loss_near_ln_vocab": abs(hist[0]["loss"] - math.log(cfg.vocab_size)) < 3.0,
        "fwd_launches": launches["flash_attention_fwd"] == 2 * L * steps,
        "dkdv_launches": launches["flash_attention_bwd_dkdv"] == L * steps,
        "dq_launches": launches["flash_attention_bwd_dq"] == L * steps,
    }
    emit("train", nvidia_smi=smi, arch=cfg.name, layers=L, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=cfg.dtype, remat=cfg.remat, batch=B,
         seq_len=S, history=hist, wall_s=wall_s, step_s=step_s,
         steady_step_ms=steady_s * 1e3, tokens_per_s=B * S / steady_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         kernel_launches=launches, checks=checks)
    _require("gemma-2b train", checks)
    return launches


# the training phases the dry run predicts: (phase, arch, overrides, B, S)
DRYRUN_TRAINS = (("train", "gemma-2b", None, 4, 2048),
                 ("ssm_train", "mamba2-2.7b", None, 4, 2048),
                 ("hybrid_train", "hymba-1.5b", None, 2, 2048),
                 ("mla_train", "deepseek-v2-lite-16b", {"num_layers": MLA_TRAIN_LAYERS}, 4, 2048),
                 ("audio_train", "musicgen-large", None, 4, 2048))
DRYRUN_CHECK_LAYERS = 2   # (c): gemma-2b at full width, 2 of its 18 layers


def dryrun_phase(torch, cfg_mod, tfm, optim, train, data, smi):
    """The dry run beside the card. (a) gemma-2b x train_4k x single, the
    reference's own example; (b) on a mesh of one, each training phase's
    step as the phase ran it (``EMITTED``): predicted peak bytes and
    roofline bound (``bound_s``, H100 datasheet constants) beside the
    measured ``peak_mem_bytes`` and ``steady_step_ms``; step over bound is
    the step's share of its roofline, read as bound / step; (c) one real
    bf16 step of gemma-2b cut to 2 layers on the card under ``analyze``
    equals the meta trace of the same step in FLOPs and bytes, with no
    collectives (gated)."""
    import dataclasses
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze
    t0 = time.perf_counter()
    cell = dryrun.run_cell("gemma-2b", "train_4k", "single")
    a_s = time.perf_counter() - t0
    predicted = {}
    for phase, arch, over, B, S in DRYRUN_TRAINS:
        res = dryrun.run_cell(arch, f"{phase}_{B}x{S}", "host", overrides=over,
                              shape=cfg_mod.ShapeConfig(f"{phase}_{B}x{S}", S, B, "train"),
                              verbose=False)
        got = EMITTED[phase]
        rt = res["roofline"]
        peak = res["memory"]["per_device_gib"] * 2 ** 30
        predicted[phase] = {
            "arch": arch, "batch": B, "seq_len": S, "overrides": over,
            "predicted_peak_bytes": peak, "measured_peak_bytes": got["peak_mem_bytes"],
            "peak_measured_over_predicted": got["peak_mem_bytes"] / peak,
            "bound_ms": rt["bound_s"] * 1e3, "dominant": rt["dominant"],
            "compute_ms": rt["compute_s"] * 1e3, "memory_ms": rt["memory_s"] * 1e3,
            "measured_steady_step_ms": got["steady_step_ms"],
            "step_over_bound": got["steady_step_ms"] / (rt["bound_s"] * 1e3),
            "roofline_share": rt["bound_s"] * 1e3 / got["steady_step_ms"],
            "model_flops": res["model_flops"]["model_flops"],
            "useful_ratio": res["model_flops"]["useful_ratio"],
            "trace_s": res["trace_s"]}
    b_s = time.perf_counter() - t0 - a_s
    # (c): the same step on the card, counted, against its meta trace
    L, B, S = DRYRUN_CHECK_LAYERS, 4, 2048
    cfg = dataclasses.replace(cfg_mod.get_config("gemma-2b"), num_layers=L)
    meta = dryrun.run_cell("gemma-2b", "check", "host", overrides={"num_layers": L},
                           shape=cfg_mod.ShapeConfig("check", S, B, "train"), verbose=False)
    gc.collect()
    torch.cuda.empty_cache()
    params = tfm.init_params(cfg, 0, device="cuda")
    opt_state = optim.init_opt_state(params)
    pipe = data.SyntheticPipeline(cfg, data.DataConfig(seq_len=S, global_batch=B, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(0).items()}
    step_fn = train.make_train_step(cfg, optim.OptConfig())
    card = analyze(step_fn, params, opt_state, batch)
    torch.cuda.synchronize()
    del params, opt_state, batch
    keys = ("flops", "dot_flops", "elementwise_flops", "transcendentals", "bytes_accessed")
    checks = {**{f"{k}_equal": card[k] == meta["hlo_analysis"][k] for k in keys},
              "kernels_equal": card["kernels"] == meta["kernels"],
              "no_collectives": card["collectives"] == {} and meta["collectives"] == {},
              "a_ok": cell["ok"], "a_n_devices": cell["n_devices"] == 256}
    emit("dryrun", nvidia_smi=smi,
         constants={"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9,
                    "source": "NVIDIA H100 SXM5 datasheet, not measured"},
         a={"cell": "gemma-2b x train_4k x single", "memory": cell["memory"],
            "roofline": cell["roofline"], "useful_ratio": cell["model_flops"]["useful_ratio"],
            "collectives": cell["collectives"], "trace_s": cell["trace_s"], "wall_s": a_s},
         b=predicted, b_wall_s=b_s,
         c={"arch": "gemma-2b", "layers": L, "batch": B, "seq_len": S,
            "card": {k: card[k] for k in keys}, "meta": {k: meta["hlo_analysis"][k] for k in keys},
            "kernels": card["kernels"]},
         wall_s=time.perf_counter() - t0, checks=checks)
    _require("dryrun", checks)


def main() -> int:
    start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch import ckpt
    from repro_torch import configs as cfg_mod
    from repro_torch import data, optim, train
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels import decode_attention as ring_view
    from repro_torch.kernels.paged_attention import ops, ref, tune
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli
    from repro_torch.models import frontends, param
    from repro_torch.models import transformer as tfm

    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    # the paged kernels' other launch plans (tune.py) build beside the rest
    sources = [ops.SOURCE, sops.SOURCE, fops.SOURCE, *ops.TILES_SOURCES.values()]
    libs = _build.build_all(sources)
    build_s = time.perf_counter() - t0
    reports = {src.stem: _build.report(src) for src in sources}
    tensor_core = {name: {"hgmma": r.get("hgmma"), "hmma": r.get("hmma")}
                   for lib in ("flash_attention", "ragged_paged_attention", "ssd_scan")
                   for name, r in reports[lib].items()
                   if name.startswith(TC_KERNELS + MMA_KERNELS)}
    emit("build", kernels=["ragged_paged_attention", "ssd_scan", "flash_attention",
                           "ragged_paged_attention_tiles", "ragged_paged_attention_tiles_fp32"],
         libraries=[str(lib.relative_to(ROOT)) for lib in libs], build_s=build_s,
         ptxas=reports, tensor_core_instructions=tensor_core)
    # where the toolkit has cuobjdump, each bf16 instantiation of the
    # redesigned kernels must run its products on the tensor cores; the SSD
    # backward's (the states kernel and the gradients kernel at one and two
    # column tasks a warp) must not spill
    _require("tensor-core build", {
        name: counts["hmma" if name.startswith(MMA_KERNELS) else "hgmma"] is None
        or counts["hmma" if name.startswith(MMA_KERNELS) else "hgmma"] > 0
        for name, counts in tensor_core.items()} | {
        f"{name} spills": r.get("spill_stores", 0) + r.get("spill_loads", 0) == 0
        for name, r in reports["ssd_scan"].items()
        if name.startswith(SSD_BWD_MMA_KERNELS)} | {
        "found": len(tensor_core) == 33,
        "ssd bwd found": sum(n.startswith(SSD_BWD_MMA_KERNELS) for n in tensor_core) == 3})
    # the tiles libraries: one instantiation per plane count and plan that
    # fits the card; every bf16 one on the tensor cores
    for dtype, src in ops.TILES_SOURCES.items():
        name = "ragged_paged_attention_mma_kernel" if dtype == torch.bfloat16 else \
            "ragged_paged_attention_kernel<"
        found = {k: r for k, r in reports[src.stem].items() if k.startswith(name)}
        _require(f"{src.stem} build", {
            "found": len(found) == 2 * len(tile_plans(tune, ops, dtype)),
            **{f"{k} hmma": r.get("hmma") is None or r["hmma"] > 0
               for k, r in found.items() if dtype == torch.bfloat16}})

    flash = [fops.flash_attention_fwd, fops.flash_attention_bwd_dkdv,
             fops.flash_attention_bwd_dq]
    kernels = [ops.ragged_paged_attention, sops.ssd_scan, sops.ssd_scan_bwd, *flash]
    seconds = {"build": build_s}    # each phase's wall time, for the budget

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    max_err, timing = timed("kernel", kernel_phase, torch, ops, ref, smi)
    ring_err, ring_timing = timed("ring kernel", ring_kernel_phase, torch, ops, ref,
                                  ring_view, smi)
    latent_err, latent_timing = timed("latent ring kernel", latent_ring_kernel_phase,
                                      torch, ops, ref, smi)
    tuned = timed("tune", tune_phase, torch, ops, ref, tune, smi)
    ssd_err, ssd_timing = timed("ssd kernel", ssd_kernel_phase, torch, sops, sref, smi)
    bwd_err, bwd_timing = timed("ssd bwd kernel", ssd_bwd_kernel_phase, torch, sops,
                                sref, smi)
    fa_err, fa_timing = timed("flash", flash_kernel_phase, torch, fops, fref, smi)
    timed("reduced qwen3", reduced_model_phase, torch, cfg_mod, tfm, param)
    timed("reduced mamba2", reduced_ssm_phase, torch, cfg_mod, tfm, param, serve)
    timed("reduced hymba", reduced_hybrid_phase, torch, cfg_mod, tfm, param, serve)
    timed("reduced deepseek", reduced_mla_phase, torch, cfg_mod, tfm, param, serve)
    for arch in ("mixtral-8x22b", "musicgen-large", "internvl2-76b"):
        timed(f"reduced {arch}", reduced_frontend_phase, torch, cfg_mod, tfm, param,
              serve, frontends, arch)
    timed("reduced ring", reduced_ring_phase, torch, cfg_mod, tfm, param, serve)
    timed("reduced ring multiarch", reduced_ring_multiarch_phase, torch, cfg_mod, tfm,
          param, serve)
    fleet_launches = timed("reduced fleet", reduced_fleet_phase, torch, cfg_mod, tfm,
                           kernels)
    rel_launches = timed("reliability", reliability_phase, torch, cfg_mod, tfm, param,
                         kernels)
    timed("init device", init_device_phase, torch, cfg_mod, tfm, param)
    timed("reduced train", reduced_train_phase, torch, cfg_mod, tfm, param, optim,
          train, data, ckpt)
    timed("reduced train multiarch", reduced_train_multiarch_phase, torch, cfg_mod, tfm,
          param, optim, train, data, frontends, fops)
    timed("full-width grads", full_width_grad_phase, torch, cfg_mod, tfm, param,
          optim, train, data, fops, fref)
    timed("mla grads", mla_grad_phase, torch, cfg_mod, tfm, param, optim, train, data, fops)
    timed("ssm grads", ssm_grad_phase, torch, cfg_mod, tfm, param, optim, train, data,
          sops)
    held = {}                        # the serve phase's weights, for the fleet
    rpa_launches = timed("serve", serve_phase, torch, cfg_mod, tfm, serve, param,
                         kernels, smi, held)
    gc.collect()                     # the qwen3-8b engine
    torch.cuda.empty_cache()
    fleet_serve_launches, inject_launches = timed(
        "fleet serve", fleet_serve_phase, torch, serve, param, kernels, smi, held)
    override_launches = timed("serve overrides", serve_overrides_phase, torch, serve, tune,
                              kernels, smi, held)
    del held
    gc.collect()                     # the qwen3-8b weights
    torch.cuda.empty_cache()
    ssd_launches, ssm_ring = timed("ssm serve", ssm_serve_phase, torch, cfg_mod, tfm,
                                   serve, param, kernels, smi)
    gc.collect()                     # the mamba2-2.7b engine and weights
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_ring = timed("hybrid serve", hybrid_serve_phase, torch,
                                         cfg_mod, tfm, serve, param, kernels, smi)
    gc.collect()                     # the hymba-1.5b engine and weights
    torch.cuda.empty_cache()
    mla_launches, mla_ring = timed("mla serve", mla_serve_phase, torch, cfg_mod, tfm,
                                   serve, param, kernels, smi)
    gc.collect()                     # the deepseek-v2-lite-16b engine and weights
    torch.cuda.empty_cache()
    frontend_launches = {}
    for phase, arch, widths in (
            ("moe_serve", "mixtral-8x22b",
             (6144, 48, 8, 128, 8, 2, 0, 16384, {4096}, 1, 0, 32768, "bfloat16")),
            ("audio_serve", "musicgen-large",
             (2048, 32, 32, 64, 0, 0, 0, 8192, {None}, 4, 0, 2048, "bfloat16")),
            ("vision_serve", "internvl2-76b",
             (8192, 64, 8, 128, 0, 0, 0, 28672, {None}, 1, 256, 128256, "bfloat16"))):
        frontend_launches[arch] = timed(
            phase.replace("_", " "), frontend_serve_phase, torch, cfg_mod, tfm, serve,
            param, kernels, smi, phase, arch, widths)
        gc.collect()                 # this engine and its weights
        torch.cuda.empty_cache()
    ring_launches, ring_paged_launches = timed("ring serve", ring_serve_phase, torch,
                                               cfg_mod, tfm, serve, param, kernels, smi)
    gc.collect()                     # the gemma2-27b weights
    torch.cuda.empty_cache()
    fa_launches = timed("train", train_phase, torch, cfg_mod, train_cli, kernels, smi)
    gc.collect()                     # the gemma-2b state
    torch.cuda.empty_cache()
    ssm_train = timed("ssm, hybrid and audio train", launcher_train_phases, torch, cfg_mod,
                      train_cli, kernels, smi)
    gc.collect()                     # the musicgen-large state
    torch.cuda.empty_cache()
    mla_train = timed("mla train", mla_train_phase, torch, cfg_mod, tfm, param, optim,
                      train, data, kernels, smi)
    gc.collect()                     # the deepseek-v2-lite-16b state
    torch.cuda.empty_cache()
    timed("dryrun", dryrun_phase, torch, cfg_mod, tfm, optim, train, data, smi)
    timed("examples", examples_phase, torch, smi)
    emit("phase_seconds", seconds=seconds, total_s=time.perf_counter() - start)

    # each serving path's counts, zeroed before it and read after it; an
    # entry's launches are their sum, its times the first path's shape
    # with the other paths' decode shapes beside them
    by_path = {
        "ragged_paged_attention": {
            "qwen3-8b serve": rpa_launches,
            "hymba-1.5b serve": hybrid_launches["ragged_paged_attention"],
            "deepseek-v2-lite-16b serve": mla_launches,
            **{f"{arch} serve": n for arch, n in frontend_launches.items()},
            "gemma2-27b paged serve": ring_paged_launches["ragged_paged_attention"],
            **{f"qwen3-8b fleet serve {clock}": n["ragged_paged_attention"]
               for clock, n in fleet_serve_launches.items()},
            "qwen3-8b inject serve": inject_launches["ragged_paged_attention"],
            "qwen3-8b serve overrides": override_launches["ragged_paged_attention"],
            "reduced fleet": fleet_launches.get("ragged_paged_attention", 0),
            "reduced reliability": rel_launches},
        "ragged_paged_attention_positions": {
            "gemma2-27b ring serve": ring_launches["ragged_paged_attention"],
            "hymba-1.5b ring serve": hybrid_ring["ragged_paged_attention"],
            "reduced fleet": fleet_launches.get("ragged_paged_attention_positions", 0)},
        "ragged_paged_attention_latent_positions": {
            "deepseek-v2-lite-16b ring serve": mla_ring["ragged_paged_attention"],
            "reduced fleet": fleet_launches.get(
                "ragged_paged_attention_latent_positions", 0)},
        **{name: {"gemma-2b train": fa_launches[name],
                  "hymba-1.5b train": ssm_train["hymba-1.5b"][name],
                  "musicgen-large train": ssm_train["musicgen-large"][name],
                  "deepseek-v2-lite-16b train (6 layers)": mla_train[name]}
           for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")},
        "flash_attention_fwd": {"gemma-2b train": fa_launches["flash_attention_fwd"],
                                "hymba-1.5b train":
                                    ssm_train["hymba-1.5b"]["flash_attention_fwd"],
                                "musicgen-large train":
                                    ssm_train["musicgen-large"]["flash_attention_fwd"],
                                "deepseek-v2-lite-16b train (6 layers)":
                                    mla_train["flash_attention_fwd"],
                                "gemma2-27b ring serve": ring_launches["flash_attention_fwd"],
                                "hymba-1.5b ring serve": hybrid_ring["flash_attention_fwd"],
                                "reduced fleet": fleet_launches["flash_attention_fwd"]},
        "ssd_scan": {"mamba2-2.7b serve": ssd_launches["ssd_scan"],
                     "hymba-1.5b serve": hybrid_launches["ssd_scan"],
                     "mamba2-2.7b ring serve": ssm_ring["ssd_scan"],
                     "hymba-1.5b ring serve": hybrid_ring["ssd_scan"],
                     "mamba2-2.7b train": ssm_train["mamba2-2.7b"]["ssd_scan"],
                     "hymba-1.5b train": ssm_train["hymba-1.5b"]["ssd_scan"],
                     "reduced fleet": fleet_launches["ssd_scan"]},
        "ssd_scan_bwd": {"mamba2-2.7b train": ssm_train["mamba2-2.7b"]["ssd_scan_bwd"],
                         "hymba-1.5b train": ssm_train["hymba-1.5b"]["ssd_scan_bwd"]}}

    def times(t):
        return {k: t[k] for k in ("ms", "ms_range", "view_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "device_ms", "library_backend")
                if k in t}

    dec, ssd = timing["decode"], ssd_timing["S32"]
    entries = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": str(ops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:225",
        "launches": sum(by_path["ragged_paged_attention"].values()),
        "launches_by_path": by_path["ragged_paged_attention"],
        "max_abs_err": max_err["bfloat16"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "device_ms": dec["device_ms"],
        # tune.py's winners at the served geometries, beside the default plan
        "launch_plans": {g: {k: t[k] for k in ("default", "default_ms", "winner", "winner_ms")}
                         for g, t in tuned.items()},
        "hymba_decode": times(timing["hymba_decode"]),
        "mla_decode": times(timing["mla_decode"]),
        **{name: times(timing[name]) for name in timing
           if name.startswith("mla_") and name != "mla_decode"},
        "mixtral_decode": times(timing["mixtral_decode"]),
        "internvl2_decode": times(timing["internvl2_decode"]),
        "musicgen_decode": times(timing["musicgen_decode"]),
        "gemma2_decode": times(timing["gemma2_decode"])}, {
        # the same kernels in their explicit-position mode: the ring path
        "name": "ragged_paged_attention_positions", "route": "cuda",
        "mode": "explicit positions (q_pos, kv_pos_pages)",
        "source": str(ops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:225",
        "launches": sum(by_path["ragged_paged_attention_positions"].values()),
        "launches_by_path": by_path["ragged_paged_attention_positions"],
        "max_abs_err": ring_err["bfloat16"],
        **times(ring_timing["wrapped_window_decode"]),
        "empty_slots_decode": times(ring_timing["empty_slots_decode"]),
        "wrapped_window_extend504": times(ring_timing["wrapped_window_extend504"]),
        "global_extend504": times(ring_timing["global_extend504"]),
        "hymba_decode": times(latent_timing["hymba_decode"])}, {
        # the latent-head kernel in position mode over one plane (V from K):
        # the MLA ring
        "name": "ragged_paged_attention_latent_positions", "route": "cuda",
        "mode": "explicit positions, one plane (v_from_k), latent head D 576",
        "source": str(ops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:225",
        "launches": sum(by_path["ragged_paged_attention_latent_positions"].values()),
        "launches_by_path": by_path["ragged_paged_attention_latent_positions"],
        "max_abs_err": latent_err["bfloat16"],
        **times(latent_timing["mla_decode"]),
        "two_planes": times(latent_timing["mla_decode_two_planes"]),
        "mla_extend48": times(latent_timing["mla_extend48"]),
        "mla_extend48_two_planes": times(latent_timing["mla_extend48_two_planes"]),
        "mla_decode_4096": times(latent_timing["mla_decode_4096"]),
        "mla_decode_4096_two_planes": times(latent_timing["mla_decode_4096_two_planes"])}, {
        "name": "ssd_scan", "route": "cuda",
        "source": str(sops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:59",
        "launches": sum(by_path["ssd_scan"].values()),
        "launches_by_path": by_path["ssd_scan"],
        "max_abs_err": ssd_err["bfloat16"],
        "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None, "device_ms": ssd["device_ms"],
        "hymba_S32": times(ssd_timing["hymba_S32"])}, {
        # the backward: no Pallas kernel, the reference differentiates its
        # jnp ssd_chunked with JAX autodiff; mamba2-2.7b's training shape,
        # hymba-1.5b's beside it
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": str(sops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/models/ssm.py:75",
        "launches": sum(by_path["ssd_scan_bwd"].values()),
        "launches_by_path": by_path["ssd_scan_bwd"],
        "max_abs_err": bwd_err["bfloat16"],
        **times(bwd_timing["mamba2"]),
        "hymba_train": times(bwd_timing["hymba"])}]
    replaces = {"flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:74",
                "flash_attention_bwd_dkdv": "src/repro/models/attention.py:126",
                "flash_attention_bwd_dq": "src/repro/models/attention.py:126"}
    for fn in flash:
        name, t = fn.__name__, fa_timing[fn.__name__]
        by = by_path[name]
        extra = {k: times(t[k]) for k in ("gemma2_27b_prefill", "hymba_ring_first_chunk",
                                          *TRAIN_SHAPES)
                 if k in t}
        entries.append({
            **extra,
            "name": name, "route": "cuda", "source": str(fops.SOURCE.relative_to(ROOT)),
            "replaces": replaces[name], "launches": sum(by.values()),
            "launches_by_path": by,
            "max_abs_err": fa_err[name]["bfloat16"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
