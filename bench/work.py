"""Operations and bytes, from shapes alone: frozen copies of the bound
formulas of ``chip_smoke.py`` (``work`` for ragged paged attention,
``ssd_work`` for the SSD chunk scan; ``repro_torch/kernels/_work.py``
records the same ones), and the useful model FLOPs a served token costs
(``mfu``). The kernel formulas take the lengths the harness recorded for a
launch instead of the launch's tensors; each sum is the closed form of the
original's loop over pages and queries (``bench/tests`` holds them equal).
"""
from __future__ import annotations


def paged_attention_work(q_rows: int, heads: int, head_dim: int, planes: int,
                         item: int, page_tokens: int, table_width: int,
                         q_lens, kv_lens, live) -> tuple:
    """(bytes, flops) of one ragged paged-attention launch (``chip_smoke.
    work``): q and the output once, the descriptors (int32 table, cu_q_lens,
    kv_lens), and the ``planes`` K/V rows of width ``head_dim`` below each
    live sequence's ``kv_len`` once; 4*D flops per attended (query head,
    key) pair, causal within a sequence's queries. ``q_rows`` counts every
    query row of the launch (inactive decode rows included); ``live[s]`` is
    False for a sequence whose table row is all null pages."""
    n_seqs = len(kv_lens)
    n_bytes = (2 * q_rows * heads * head_dim * item
               + 4 * (n_seqs * table_width + n_seqs + 1 + n_seqs))
    flops = 0
    for qlen, kv, ok in zip(q_lens, kv_lens, live):
        if not ok:
            continue
        n_bytes += planes * head_dim * item * kv
        # query i attends keys [0, kv - qlen + i + 1)
        flops += 4 * head_dim * heads * (qlen * (kv - qlen) + qlen * (qlen + 1) // 2)
    return n_bytes, flops


def ssd_work(B: int, S: int, H: int, P: int, G: int, N: int, item: int,
             with_state: bool, block: int = 32) -> tuple:
    """(bytes, flops) of one SSD chunk-scan launch (``chip_smoke.ssd_work``):
    x, b, c, dt, a and the initial state read once, y and the final state
    written once; per (batch, head) and 32-token block of L tokens the lower
    triangle of C.B^T (N*L*(L+1)) and of its product with x*dt (P*L*(L+1)),
    and the carried-state output and state update (2*L*P*N each)."""
    x_numel = B * S * H * P
    bc_numel = 2 * B * S * G * N
    n_bytes = (2 * x_numel * item + bc_numel * item
               + 4 * (B * S * H + H + B * H * P * N)
               + (4 * B * H * P * N if with_state else 0))
    flops = 0
    for t0 in range(0, S, block):
        L = min(block, S - t0)
        flops += N * L * (L + 1) + P * L * (L + 1) + 4 * L * P * N
    return n_bytes, flops * B * H


# ---------------------------------------------------------------------------
# Useful model FLOPs (mfu): what a token needs, not what the eager port runs
# ---------------------------------------------------------------------------


def mamba2_token_flops(m: dict, context: int) -> dict:
    """FLOPs one token of a Mamba2 stack costs (independent of context):
    the in and out projections, the depthwise conv, and the SSD update and
    read of the (heads, headdim, state) state, 2 per multiply-add. The head
    (tied embedding) is counted apart."""
    d = m["d_model"]
    di = m["expand"] * d
    ng, ns, hd = m["ngroups"], m["d_state"], m["headdim"]
    nh = di // hd
    conv_dim = di + 2 * ng * ns
    per_layer = (d * (2 * di + 2 * ng * ns + nh) + m["d_conv"] * conv_dim
                 + 2 * nh * hd * ns + di * d)
    return {"layers": 2 * per_layer * m["n_layer"], "head": 2 * d * m["vocab_size"]}


TOKEN_FLOPS = {"mamba2": mamba2_token_flops}
