"""The schedule of the bf16 latent-head (MLA) paged-attention kernel
(``ragged_paged_attention_latent_kernel`` in
``src/repro_torch/kernels/paged_attention/csrc/ragged_paged_attention.cu``),
transcribed to float64 numpy and held against the JAX package's
``paged_attention_rows`` at the latent geometry: 16 query heads on one KV
head of D 576, r 512, random pages. Inputs are made with numpy and handed
to both; the port's plain version (the CPU path of
``ragged_paged_attention``) is held against the transcription too.

The transcription follows the kernel's plan, which no CPU test can run:

- rows are (token, query head) pairs flattened token-major, cut into tiles
  of 16 (``kMmaRows``); a CTA holds one tile for decode and ``EXTEND_TILES``
  (the kernel's NT = 2) for anything longer, sharing every staged block;
- the table's slots are cut into splits of ``latent_split_pages(ps)`` pages
  (``kLatentSplitKeys`` keys rounded down to whole pages) counted from slot
  0; a split walks its visited keys in blocks of ``kLatentBlock`` keys,
  counted from the split's first key, keeping a per-row (m, l, acc); keys
  outside the visited slots (causal limit, window, null pages) are zero
  rows at position -1;
- the partials fold in split order within clusters of ``kLatentCluster``
  consecutive splits, then the clusters' partials fold in cluster order,
  each fold weighting a state by exp(m - M), M the largest m of a state
  with a visible key.

Cases: two planes ([c, kr] / [c, 0], the paged pool) and one (the ring's
[c, kr], value = key); decodes spanning one split and several clusters;
extends of several tiles; null slots, a window and a softcap; explicit
positions with empty rows; pages of 16, 32 and 64. A last test reads the
``.cu`` file and checks the constants mirrored here.
"""
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import paged_attention_rows as jax_rows
from repro_torch.kernels.paged_attention import ragged_paged_attention
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

# mirrored from ragged_paged_attention.cu
TILE_ROWS = 16            # kMmaRows: rows of a tile
EXTEND_TILES = 2          # NT of the extend instantiation: tiles a CTA
BLOCK = 32                # kLatentBlock: keys of one online-softmax step
SPLIT_KEYS = 192          # kLatentSplitKeys
CLUSTER = 8               # kLatentCluster
NEG_INF = -2.0e38         # kNegInf

HQ, D, R_LAT = 16, 576, 512
SCALE = (128 + 64) ** -0.5
SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "paged_attention" / "csrc" / "ragged_paged_attention.cu")


def split_pages(ps):
    """latent_split_pages: a function of the page size alone."""
    return max(1, SPLIT_KEYS // ps)


def fold_all(parts):
    """The kernel's fold of softmax states in order, row by row: M the
    largest m of a state with a visible key (l != 0), w = exp(m - M) (0 for
    none), l = sum of l w, acc = sum of acc w."""
    m = np.stack([p[0] for p in parts])
    l = np.stack([p[1] for p in parts])
    a = np.stack([p[2] for p in parts])
    seen = l != 0
    M = np.where(seen, m, -np.inf).max(axis=0)
    w = np.where(seen, np.exp(np.where(seen, m - np.where(np.isfinite(M), M, 0.0), 0.0)), 0.0)
    return (np.where(np.isfinite(M), M, NEG_INF), (l * w).sum(axis=0),
            (a * w[..., None]).sum(axis=0))


def latent_plan(q, pages, table, cu, kv_lens, *, scale, cap=None, window=None,
                q_pos=None, kv_pos=None, v_from_k=False):
    """The kernel's schedule in float64. q (T, Hq, D); pages (P, ps, 1 or 2,
    D); table (S, W); cu (S+1,); kv_lens (S,); q_pos (T,) and kv_pos (P, ps)
    both or neither. Returns (T, Hq, D) float64."""
    T, Hq, d = q.shape
    P, ps = pages.shape[:2]
    S, W = table.shape
    G = Hq                                       # one KV head
    k_all = pages[:, :, 0].astype(np.float64)
    v_all = k_all if v_from_k else pages[:, :, 1].astype(np.float64)
    has_pos = q_pos is not None
    max_q_len = int(max(cu[i + 1] - cu[i] for i in range(S)))
    rows_cta = TILE_ROWS * (1 if max_q_len * G <= TILE_ROWS else EXTEND_TILES)
    sp = split_pages(ps)
    out = np.zeros((T, Hq, d))
    for s in range(S):
        q0, qlen, kv_len = int(cu[s]), int(cu[s + 1] - cu[s]), int(kv_lens[s])
        n_slots = min(-(-kv_len // ps), W)
        n_splits = max(1, -(-n_slots // sp))
        for row0 in range(0, qlen * G, rows_cta):
            row_end = min(row0 + rows_cta, qlen * G)
            rows = np.arange(row0, row_end)
            tok, head = q0 + rows // G, rows % G
            qr = q[tok, head].astype(np.float64)
            qp = q_pos[tok] if has_pos else kv_len - qlen + rows // G
            first_qpos = kv_len - qlen + row0 // G
            last_qpos = kv_len - qlen + (row_end - 1) // G
            hi = n_slots if has_pos else min(n_slots, last_qpos // ps + 1)
            lo = max(first_qpos - window + 1, 0) // ps if window and not has_pos else 0
            parts = []
            for j in range(n_splits):
                key0 = j * sp * ps
                ka, kb = max(lo, j * sp) * ps, min(hi, (j + 1) * sp) * ps
                m = np.full(len(rows), NEG_INF)
                l, a = np.zeros(len(rows)), np.zeros((len(rows), d))
                blocks = range((ka - key0) // BLOCK, -(-(kb - key0) // BLOCK)) if kb > ka else ()
                for b in blocks:
                    keys = key0 + b * BLOCK + np.arange(BLOCK)
                    slot, krow = keys // ps, keys % ps
                    pid = table[s, np.clip(slot, 0, W - 1)]
                    live = ((keys >= ka) & (keys < kb) & (pid >= (0 if has_pos else 1))
                            & (pid < P))
                    kpos = np.where(live, kv_pos[pid, krow] if has_pos else keys, -1)
                    kk = np.where(live[:, None], k_all[pid, krow], 0.0)
                    vv = np.where(live[:, None], v_all[pid, krow], 0.0)
                    sc = qr @ kk.T * scale
                    if cap is not None:
                        sc = np.tanh(sc / cap) * cap
                    valid = (kpos >= 0)[None] & (kpos[None] <= qp[:, None])
                    if window is not None:
                        valid &= kpos[None] > qp[:, None] - window
                    sc = np.where(valid, sc, NEG_INF)
                    m_new = np.maximum(m, sc.max(axis=1))
                    p = np.where(valid, np.exp(sc - m_new[:, None]), 0.0)
                    corr = np.exp(m - m_new)
                    l, a, m = l * corr + p.sum(axis=1), a * corr[:, None] + p @ vv, m_new
                parts.append((m, l, a))
            clusters = [fold_all(parts[c:c + CLUSTER]) for c in range(0, n_splits, CLUSTER)]
            _, l, a = fold_all(clusters)
            out[tok, head] = a / np.where(l == 0, 1.0, l)[:, None]
    return out


def pool(rng, kv_lens, ps, *, planes, sparse=False, extra=0):
    """A shuffled pool of latent pages: (q, pages, table) with sequence s on
    ceil(kv_lens[s] / ps) random page ids, page 0 null; two planes are [c,
    kr] / [c, 0], one [c, kr]. ``sparse`` nulls every third slot."""
    n_pages = [-(-k // ps) for k in kv_lens]
    P = 1 + sum(n_pages)
    perm = 1 + rng.permutation(P - 1)
    table = np.zeros((len(kv_lens), max(n_pages) + extra), np.int32)
    for s, n in enumerate(n_pages):
        table[s, :n], perm = perm[:n], perm[n:]
    if sparse:
        table[:, 1::3] = 0
    ckr = rng.standard_normal((P, ps, 1, D)).astype(np.float32)
    ckr[0] = 0
    if planes == 1:
        return ckr, table
    cz = ckr.copy()
    cz[..., R_LAT:] = 0
    return np.concatenate([ckr, cz], axis=2), table


def reference(q, pages, table, cu, kv_lens, *, v_from_k, q_pos=None, kv_pos=None,
              cap=None, window=None):
    """JAX's paged_attention_rows on per-row tables (fp32); one plane is
    handed over as two equal planes."""
    two = np.concatenate([pages, pages], axis=2) if v_from_k else pages
    seg = np.searchsorted(cu[1:], np.arange(q.shape[0]), side="right")
    if q_pos is None:
        q_lens = np.diff(cu)
        q_pos = (kv_lens[seg] - q_lens[seg] + np.arange(q.shape[0]) - cu[seg]).astype(np.int32)
    return np.asarray(jax_rows(q, two, table[seg], q_pos, scale=SCALE, cap=cap,
                               window=window, kv_pos_pages=kv_pos))


def port(q, pages, table, cu, kv_lens, *, v_from_k, q_pos=None, kv_pos=None, cap=None,
         window=None):
    """The port's wrapper on CPU tensors: its plain version."""
    t = torch.from_numpy
    return ragged_paged_attention(
        t(q), t(pages), t(table), t(cu), t(kv_lens), scale=SCALE, cap=cap, window=window,
        q_pos=None if q_pos is None else t(q_pos),
        kv_pos_pages=None if kv_pos is None else t(kv_pos), v_from_k=v_from_k).numpy()


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


CASES = {   # name: (q_lens, kv_lens, page size, options)
    # one split (the serve lengths), several, and two clusters (10 splits)
    "decode_spans": ([1, 1, 1], [40, 700, 1800], 32, {}),
    "extend_tiles": ([6, 1, 9], [150, 400, 1700], 32, {}),
    "decode_ps16": ([1, 1], [90, 2100], 16, {}),
    "extend_ps64": ([5, 1], [1000, 64], 64, {}),
    "null_slots_window_cap": ([3, 1, 2], [300, 900, 1600], 32,
                              {"sparse": True, "window": 500, "cap": 30.0}),
}


@pytest.mark.parametrize("planes", [2, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_reference(name, planes):
    q_lens, kv_lens, ps, opts = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + planes)
    pages, table = pool(rng, kv_lens, ps, planes=planes, sparse=opts.get("sparse", False),
                        extra=3)
    q = rng.standard_normal((sum(q_lens), HQ, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    kl = np.asarray(kv_lens, np.int32)
    kw = dict(cap=opts.get("cap"), window=opts.get("window"))
    plan = latent_plan(q, pages, table, cu, kl, scale=SCALE, v_from_k=planes == 1, **kw)
    _close(plan, reference(q, pages, table, cu, kl, v_from_k=planes == 1, **kw), 1e-5)
    _close(port(q, pages, table, cu, kl, v_from_k=planes == 1, **kw), plan, 1e-5)
    if planes == 2:   # V' = [c, 0]: lanes [r, r + dr) are exact zeros
        assert not plan[..., R_LAT:].any()


@pytest.mark.parametrize("planes", [2, 1])
@pytest.mark.parametrize("q_len", [1, 5])
def test_plan_positions_with_empty_rows(q_len, planes):
    """Explicit positions: four wrapped rings of 1,024 slots read as pages
    of 32 (every slot visited, page 0 a page like any other), 3% of the
    rows empty (-1), queries at and behind the newest key."""
    rng = np.random.default_rng(40 + q_len + planes)
    C, ps, B = 1024, 32, 4
    n_per = C // ps
    newest = [1024, 1500, 2700, 1100]
    pos = np.full((B, C), -1, np.int32)
    for b, hi in enumerate(newest):
        p = np.arange(max(0, hi - C), hi)
        pos[b, p % C] = p
    pos[rng.random((B, C)) < 0.03] = -1
    ckr = rng.standard_normal((B * n_per, ps, 1, D)).astype(np.float32)
    pages = ckr
    if planes == 2:
        cz = ckr.copy()
        cz[..., R_LAT:] = 0
        pages = np.concatenate([ckr, cz], axis=2)
    table = np.arange(B * n_per, dtype=np.int32).reshape(B, n_per)
    kv_pos = pos.reshape(B * n_per, ps)
    q = rng.standard_normal((B * q_len, HQ, D)).astype(np.float32)
    cu = np.arange(0, (B + 1) * q_len, q_len, dtype=np.int32)
    kl = np.full(B, C, np.int32)
    q_pos = np.concatenate([np.arange(hi - q_len, hi) for hi in newest]).astype(np.int32)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=700 if q_len > 1 else None)
    plan = latent_plan(q, pages, table, cu, kl, scale=SCALE, v_from_k=planes == 1, **kw)
    _close(plan, reference(q, pages, table, cu, kl, v_from_k=planes == 1, **kw), 1e-5)
    _close(port(q, pages, table, cu, kl, v_from_k=planes == 1, **kw), plan, 1e-5)


@pytest.mark.parametrize("ps", [16, 32, 64])
def test_split_plan(ps):
    """The plan's sizes: a sequence at the serve lengths (96 keys) is one
    split; 4 x 4096 tokens give 3 clusters of 8 splits each (12 clusters:
    one wave at 15 resident); the fp32 partial of a split is at most about
    an eighth of the two-plane KV bytes it summarises."""
    sp = split_pages(ps)
    assert sp * ps <= SPLIT_KEYS and -(-96 // ps) <= sp
    n_splits = -(-(4096 // ps) // sp)
    assert math.ceil(n_splits / CLUSTER) == 3
    partial = TILE_ROWS * (D + 2) * 4
    assert partial <= (sp * ps * 2 * D * 2) / 8


def test_constants_mirror_the_source():
    src = SOURCE.read_text()
    want = {"kMmaRows": TILE_ROWS, "kLatentBlock": BLOCK, "kLatentSplitKeys": SPLIT_KEYS,
            "kLatentCluster": CLUSTER, "kLatentD": D}
    for name, value in want.items():
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert re.search(r"p\.nt = rows <= kMmaRows \? 1 : (\d+);", src).group(1) == str(EXTEND_TILES)
    assert "return max(1, kLatentSplitKeys / page_size);" in src
    assert "kNegInf = -2.0e38f" in src
