"""The port's gather count (``repro_torch.kernels.paged_attention.
pages_gathered``): the host-side replica of the page loads one launch of
the Hopper paged kernels issues under its plan, in (page, KV head) slabs.

- a closed form on dense decode: every page below ``kv_len`` once per KV
  head, whatever the plan;
- the replica equals a walk of the kernels' own loops (tiles, groups of
  splits, each warp's slots; spread or folded) on random ragged batches,
  for every plan of the tuner's grid;
- trailing null slots change nothing; the sparse table of the
  reference's ``test_grouped_grid_sparse_table_parity`` reads strictly
  fewer slabs than ``skip_blocks=False``; a window lowers the count; the
  explicit-position mode counts every slot below ``ceil(kv_len / ps)``,
  page 0 included; the latent head counts on its own tiles.
On the card ``chip_smoke.py`` holds the replica equal to the kernels'
``gathered`` counter.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import pages_gathered, ragged_paged_attention
from repro_torch.kernels.paged_attention import tune


def _walk(tbl, cu, kvl, *, ps, max_q_len, hq, hkv, d, dtype, block_q=None, block_kv=None,
          window=None, positions=False, num_pages=None):
    """The slabs the kernels stage, by their own loops
    (``ragged_paged_attention_kernel`` / ``_mma_kernel``): per (tile, KV
    head, sequence) CTA, the groups it folds (all of them, one a CTA when
    the launch spreads), per warp its split's slots in [lo, hi)."""
    G = hq // hkv
    S, W = tbl.shape
    cfg = tune.resolve_config(ps, d, max_q_len, W, block_q, block_kv, dtype=dtype, group=G)
    rows = tune.tile_rows(cfg.block_q, dtype)
    spread = max_q_len * G <= 16

    def max_groups():
        def groups(n):
            g = tune.split_slots(n, cfg.block_kv) * tune.WARPS
            return (n + g - 1) // g
        most = groups(W)
        for end in range(127, 64 * (cfg.block_kv + 1), 64):
            most = max(most, groups(min(end, W)))
        return most

    n_groups = max_groups()
    total = 0
    for s in range(S):
        q0, qlen, kv_len = int(cu[s]), int(cu[s + 1] - cu[s]), int(kvl[s])
        n_pages = -(-kv_len // ps)
        for tile in range(-(-max_q_len * G // rows)):
            row0 = tile * rows
            if row0 >= qlen * G:
                continue
            row_end = min(row0 + rows, qlen * G)
            first_qpos = kv_len - qlen + row0 // G
            last_qpos = kv_len - qlen + (row_end - 1) // G
            hi = min(n_pages, W) if positions else min(n_pages, last_qpos // ps + 1, W)
            lo = max(first_qpos - window + 1, 0) // ps if window and not positions else 0
            slots = tune.split_slots(n_pages, cfg.block_kv)
            gs = slots * tune.WARPS
            grps = (range(n_groups) if spread
                    else range(lo // gs, (hi - 1) // gs + 1 if hi > lo else lo // gs))
            for g in grps:
                for warp in range(tune.WARPS):
                    for sl in range(max(lo, g * gs + warp * slots),
                                    min(hi, g * gs + (warp + 1) * slots)):
                        pid = int(tbl[s, sl])
                        if pid >= (0 if positions else 1) and (num_pages is None
                                                                 or pid < num_pages):
                            total += 1
    return total * hkv


def _batch(rng, q_lens, kv_lens, ps, extra_null=0, sparse=0.0):
    n = [-(-k // ps) for k in kv_lens]
    W = max(n) + extra_null
    tbl = np.zeros((len(kv_lens), W), np.int32)
    perm = 1 + rng.permutation(sum(n))
    for s, m in enumerate(n):
        tbl[s, :m], perm = perm[:m], perm[m:]
    if sparse:
        tbl[rng.random(tbl.shape) < sparse] = 0
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return tbl, cu, np.asarray(kv_lens, np.int32), 1 + sum(n)


@pytest.mark.parametrize("ps", [16, 32, 64])
@pytest.mark.parametrize("block_q,block_kv", [(None, None), (32, 4), (16, 16)])
def test_dense_decode_closed_form(ps, block_q, block_kv):
    kv = [1, 33, 200, 4500, 9000]
    tbl, cu, kvl, _ = _batch(np.random.default_rng(0), [1] * len(kv), kv, ps)
    for hq, hkv in ((32, 8), (25, 5), (16, 1)):
        got = pages_gathered(tbl, cu, kvl, page_size=ps, max_q_len=1, block_q=block_q,
                             block_kv=block_kv, num_q_heads=hq, num_kv_heads=hkv)
        assert got == hkv * sum(-(-k // ps) for k in kv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geo", [(32, 8, 128), (25, 5, 64), (32, 32, 64), (16, 1, 576)])
def test_replica_equals_the_kernels_loops(dtype, geo):
    hq, hkv, d = geo
    rng = np.random.default_rng(1)
    plans = [tune.KernelConfig(bq, bkv, 2) for bq in tune.CANDIDATE_BLOCK_Q
             for bkv in tune.CANDIDATE_BLOCK_KV]
    for trial in range(6):
        ps = [16, 32, 64][trial % 3]
        q_lens = [int(x) for x in rng.integers(1, 40, 3)] if trial % 2 else [1, 1, 1]
        kv_lens = [int(q + rng.integers(0, 9000)) for q in q_lens]
        tbl, cu, kvl, P = _batch(rng, q_lens, kv_lens, ps, extra_null=trial, sparse=0.3)
        for plan in plans:
            for window, positions in ((None, False), (700, False), (None, True)):
                kw = dict(ps=ps, max_q_len=max(q_lens), hq=hq, hkv=hkv, d=d, dtype=dtype,
                          block_q=plan.block_q, block_kv=plan.block_kv, window=window,
                          positions=positions, num_pages=P)
                if tune.is_latent(d, dtype):
                    continue        # the latent kernel's own loops: the next test
                got = pages_gathered(tbl, cu, kvl, page_size=ps, max_q_len=max(q_lens),
                                     block_q=plan.block_q, block_kv=plan.block_kv,
                                     window=window, num_q_heads=hq, num_kv_heads=hkv,
                                     head_dim=d, dtype=dtype, positions=positions,
                                     num_pages=P)
                assert got == _walk(tbl, cu, kvl, **kw) > 0


def test_latent_head_counts_on_its_own_tiles():
    """D 576 in bf16: 16-row tiles for decode, 32 for longer launches,
    whatever block_q says; splits of ~192 keys visit [lo, hi) between
    them."""
    ps, hq = 32, 16
    tbl, cu, kvl, _ = _batch(np.random.default_rng(2), [1, 3], [700, 4096], ps)
    kw = dict(page_size=ps, num_q_heads=hq, num_kv_heads=1, head_dim=576,
              dtype=torch.bfloat16)
    dec = pages_gathered(tbl, np.array([0, 1, 2], np.int32), kvl, max_q_len=1, **kw)
    assert dec == sum(-(-k // ps) for k in (700, 4096))
    for bq in (16, 32):
        # 3 tokens x 16 heads: two 32-row tiles for the second sequence, each
        # reaching its own last key
        got = pages_gathered(tbl, cu, kvl, max_q_len=3, block_q=bq, **kw)
        assert got == -(-700 // ps) + (4094 // ps + 1) + -(-4096 // ps)


@pytest.mark.parametrize("positions", [False, True])
def test_trailing_null_slots_change_nothing(positions):
    rng = np.random.default_rng(3)
    q_lens, kv_lens = [5, 1, 48, 20], [37, 64, 600, 900]
    tbl, cu, kvl, _ = _batch(rng, q_lens, kv_lens, 32, sparse=0.3)
    wide = np.concatenate([tbl, np.zeros((4, 20), np.int32)], axis=1)
    for plan in (None, tune.KernelConfig(32, 4, 3)):
        kw = dict(page_size=32, max_q_len=48, num_q_heads=32, num_kv_heads=8,
                  positions=positions, block_q=plan and plan.block_q,
                  block_kv=plan and plan.block_kv)
        assert pages_gathered(tbl, cu, kvl, **kw) == pages_gathered(wide, cu, kvl, **kw)


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("q_lens,kv_lens", [
    ([5, 1, 9], [37, 12, 9]),          # mixed extend + decode, ragged
    ([1, 1, 1, 1], [33, 7, 64, 17]),   # pure batched decode
])
def test_sparse_table_reads_fewer_slabs(ps, q_lens, kv_lens):
    """The reference test's case (Hq 4, Hkv 2, every other slot null)."""
    tbl, cu, kvl, _ = _batch(np.random.default_rng(0), q_lens, kv_lens, ps)
    tbl[:, 1::2] = 0
    kw = dict(page_size=ps, max_q_len=max(q_lens), num_q_heads=4, num_kv_heads=2,
              head_dim=32)
    grouped = pages_gathered(tbl, cu, kvl, **kw)
    full = pages_gathered(tbl, cu, kvl, skip_blocks=False, **kw)
    assert 0 < grouped < full


def test_window_lowers_the_count():
    rng = np.random.default_rng(4)
    tbl, cu, kvl, _ = _batch(rng, [1, 20, 3], [4500, 1000, 600], 32)
    kw = dict(page_size=32, max_q_len=20, num_q_heads=48, num_kv_heads=8)
    full = pages_gathered(tbl, cu, kvl, **kw)
    win = pages_gathered(tbl, cu, kvl, window=300, **kw)
    assert 0 < win < full
    # decode at window 300 over pages of 32: 11 or 12 pages a sequence
    dec = pages_gathered(tbl[:1], cu[:2] * 0 + np.array([0, 1]), kvl[:1], page_size=32,
                         max_q_len=1, num_q_heads=48, num_kv_heads=8, window=300)
    assert dec == 8 * (-(-4500 // 32) - (4500 - 300) // 32)


def test_positions_count_every_slot_below_kv_len():
    """Explicit positions (the ring view): no slot is skipped from the
    lengths, page 0 included; a slot past the pool is still skipped."""
    rng = np.random.default_rng(5)
    q_lens, kv_lens, ps = [5, 1, 48], [37, 900, 4100], 32
    tbl, cu, kvl, P = _batch(rng, q_lens, kv_lens, ps)
    tbl[:, 1::2] = 0
    G, hkv = 4, 8
    kw = dict(page_size=ps, max_q_len=48, num_q_heads=G * hkv, num_kv_heads=hkv,
              num_pages=P)
    got = {}
    for bq in (16, 32):
        got[bq] = pages_gathered(tbl, cu, kvl, block_q=bq, positions=True, **kw)
        tiles = [-(-q * G // bq) for q in q_lens]
        assert got[bq] == hkv * sum(t * -(-k // ps) for t, k in zip(tiles, kv_lens))
        assert pages_gathered(tbl, cu, kvl, block_q=bq, **kw) < got[bq]
    tbl[0, 0] = P          # out of the pool: skipped (sequence 0: 5 x 4 rows, 2 tiles)
    assert pages_gathered(tbl, cu, kvl, positions=True, **kw) == got[16] - hkv * 2


def test_gathered_counts_only_the_card():
    """The plain version has no page loads to count: a ``gathered``
    counter on the CPU raises."""
    q = torch.zeros((1, 4, 32))
    kv = torch.zeros((2, 16, 2, 32))
    tbl = torch.tensor([[1]], dtype=torch.int32)
    cu = torch.tensor([0, 1], dtype=torch.int32)
    kvl = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="gathered"):
        ragged_paged_attention(q, kv, tbl, cu, kvl, scale=1.0,
                               gathered=torch.zeros(1, dtype=torch.int32))
