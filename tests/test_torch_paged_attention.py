"""The port's ragged paged attention against the JAX package: the plain
PyTorch version against the jnp reference over the reference tests' case
grid and against the Pallas kernel in interpret mode, the in-place KV
write against JAX's scatter, table-padding bit-invariance within the
port, and the wrapper's CPU routing. Inputs are made with numpy and
handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ragged_paged_attention as jax_rpa
from repro.kernels.paged_attention import ragged_paged_attention_ref as jax_rpa_ref
from repro.kernels.paged_attention import write_tokens_to_pages as jax_write
from repro_torch.kernels.paged_attention import (interleave_kv,
                                                 ragged_paged_attention,
                                                 ragged_paged_attention_ref,
                                                 split_kv,
                                                 write_tokens_to_pages)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=3e-6, rtol=3e-6)   # the JAX package's own kernel tolerance


def _case(q_lens, kv_lens, ps, Hq, Hkv, D, extra_pages=0, seed=7):
    """Numpy twin of tests/test_paged_attention.py::_case: every sequence
    gets its own page run; page 0 stays the null page; ``extra_pages`` pads
    each table row with trailing null slots."""
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    W = max(-(-k // ps) for k in kv_lens)
    P = 1 + S * W
    kv_pages = rng.normal(0, 1, (P, ps, 2 * Hkv, D)).astype(np.float32)
    table = np.zeros((S, W + extra_pages), np.int32)
    for s, klen in enumerate(kv_lens):
        n = -(-klen // ps)
        table[s, :n] = 1 + s * W + np.arange(n)
    q = rng.normal(0, 1, (sum(q_lens), Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return q, kv_pages, table, cu, np.asarray(kv_lens, np.int32)


def _port(args):
    return [torch.from_numpy(a) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("q_lens,kv_lens", [
    ([5, 1, 9], [37, 12, 9]),          # mixed extend + decode, ragged
    ([1, 1, 1, 1], [33, 7, 64, 17]),   # pure batched decode
    ([16], [48]),                      # single chunked-extend sequence
])
@pytest.mark.parametrize("cap,window", [(None, None), (30.0, None),
                                        (None, 20), (30.0, 20)])
def test_plain_matches_jax_reference(ps, q_lens, kv_lens, cap, window):
    case = _case(q_lens, kv_lens, ps, Hq=4, Hkv=2, D=16)
    kw = dict(scale=16 ** -0.5, cap=cap, window=window)
    out = ragged_paged_attention_ref(*_port(case), **kw)
    ref = jax_rpa_ref(*_jax(case), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ps,q_lens,kv_lens,cap,window", [
    (8, [5, 1, 9], [37, 12, 9], None, None),
    (16, [1, 1, 1, 1], [33, 7, 64, 17], 30.0, None),
    (32, [16], [48], 30.0, 20),
])
def test_plain_matches_pallas_interpret(ps, q_lens, kv_lens, cap, window):
    case = _case(q_lens, kv_lens, ps, Hq=4, Hkv=2, D=16)
    kw = dict(scale=16 ** -0.5, cap=cap, window=window)
    out = ragged_paged_attention_ref(*_port(case), **kw)
    ref = jax_rpa(*_jax(case), max_q_len=max(q_lens), backend="pallas",
                  interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sparse_table_masks_interior_nulls():
    """Interior null slots hold no keys: the port masks them by page id,
    as the JAX reference does."""
    q, kvp, tbl, cu, kl = _case([5, 1, 9], [37, 12, 9], 8, 4, 2, 16)
    tbl = tbl.copy()
    tbl[:, 1::2] = 0
    case = (q, kvp, tbl, cu, kl)
    out = ragged_paged_attention_ref(*_port(case), scale=0.25)
    ref = jax_rpa_ref(*_jax(case), scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_table_padding_bit_invariance():
    """Trailing null-page slots leave the online softmax bit-identical."""
    args = dict(q_lens=[4, 7], kv_lens=[29, 18], ps=8, Hq=2, Hkv=1, D=8)
    q, kvp, tbl0, cu, kl = _port(_case(**args))
    tbl4 = torch.from_numpy(_case(extra_pages=4, **args)[2])
    out0 = ragged_paged_attention_ref(q, kvp, tbl0, cu, kl, scale=0.3)
    out4 = ragged_paged_attention_ref(q, kvp, tbl4, cu, kl, scale=0.3)
    assert torch.equal(out0, out4)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    case = _port(_case([5, 1, 9], [37, 12, 9], 16, 4, 2, 16))
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*case, scale=0.25, cap=30.0, window=20)
    ref = ragged_paged_attention_ref(*case, scale=0.25, cap=30.0, window=20)
    assert torch.equal(out, ref)
    assert ragged_paged_attention.launches == before   # no kernel launched


def test_write_tokens_to_pages_matches_jax():
    """In-place scatter == JAX's drop-mode scatter, including inactive rows,
    positions past the table width and negative positions; page 0 is never
    written."""
    rng = np.random.default_rng(3)
    P, ps, Hkv, D = 9, 4, 2, 8
    B, S, W = 3, 5, 2
    pool = rng.normal(0, 1, (P, ps, 2 * Hkv, D)).astype(np.float32)
    pool[0] = 0.0
    kv_new = rng.normal(0, 1, (B, S, 2 * Hkv, D)).astype(np.float32)
    table = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    positions = np.array([[0, 1, 2, 3, 4],          # row 0: all in range
                          [5, 6, 7, 8, 9],          # row 1: 8, 9 past W*ps
                          [-1, 2, 3, 4, 5]], np.int64)  # row 2: inactive
    active = np.array([True, True, False])

    ref = jax_write(jnp.asarray(pool), jnp.asarray(kv_new),
                    jnp.asarray(positions), jnp.asarray(table),
                    active=jnp.asarray(active))
    out = torch.from_numpy(pool.copy())
    ret = write_tokens_to_pages(out, torch.from_numpy(kv_new),
                                torch.from_numpy(positions),
                                torch.from_numpy(table),
                                active=torch.from_numpy(active))
    assert ret is out                                 # written in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not out[0].any()

    # without an active mask every in-range row lands, as in JAX
    ref = jax_write(jnp.asarray(pool), jnp.asarray(kv_new),
                    jnp.asarray(np.maximum(positions, 0)), jnp.asarray(table))
    out = torch.from_numpy(pool.copy())
    write_tokens_to_pages(out, torch.from_numpy(kv_new),
                          torch.from_numpy(np.maximum(positions, 0)),
                          torch.from_numpy(table))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_interleave_layout_roundtrip():
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.normal(0, 1, (2, 5, 3, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (2, 5, 3, 4)).astype(np.float32))
    kv = interleave_kv(k, v)
    assert kv.shape == (2, 5, 6, 4)
    k2, v2 = split_kv(kv)
    assert torch.equal(k2, k) and torch.equal(v2, v)
