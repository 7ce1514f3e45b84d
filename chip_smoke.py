#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
Hopper card: both serving paths, dense attention (qwen3-8b) and SSM
(mamba2-2.7b), the training path (gemma-2b), and their five kernels.

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
                 dQ kernels and HMMA in the bf16 paged-attention kernel;
3. kernel      — holds ragged paged attention against its plain PyTorch
                 version at the qwen3-8b path's geometry (fp32 and bf16,
                 decode / sparse table / extend / softcap / window, and
                 KV ranges of more splits than one CTA takes), checks
                 bit-equality under trailing null table slots and between
                 a row's decode and extend launches, and times the kernel,
                 its plain version and one PyTorch library call (CUDA
                 events, L2 flushed; the kernel and the library call also
                 by the profiler's device time) at the main path's decode,
                 an extend and a long decode (4 x 4096);
4. ssd kernel  — holds the SSD chunk scan against its plain version (y and
                 final state) at the mamba2-2.7b path's geometry (H 80, P
                 64, N 128) for S 1/9/32, a multi-chunk S 512, a G > 1
                 batch, zero and random initial states, fp32 and bf16;
                 checks that two launches are bit-equal; times the kernel
                 and its plain version (no single PyTorch call computes an
                 SSD scan);
5. flash       — holds the flash-attention forward and both backward
                 kernels against their plain versions and against autograd
                 through the naive oracle, at the gemma-2b (B 4, S 2048, H 8,
                 Hkv 1, D 256) and qwen3-8b (H 32, Hkv 8, D 128) geometries,
                 with softcap 50 + window 64, at a ragged S 1000, at D 64
                 and D 32, at S 17 (below a tile) and with G = 3, fp32 and
                 bf16 (bf16 through the tensor-core forward, dK/dV and dQ
                 kernels); checks that repeat launches are bit-equal; times the
                 three kernels (achieved TFLOP/s, share of the bound; dK/dV
                 also without its row split), their plain versions and
                 ``scaled_dot_product_attention`` (forward, forward +
                 backward) at the gemma-2b shape, and records the bf16
                 kernels and plain versions against float64 there;
6. reduced     — the models' paged prefill / extend / decode on reduced fp32
                 qwen3-8b and mamba2-2.7b, CUDA (the kernels) against the
                 CPU path (the plain versions), same weights; and on CUDA a
                 reduced mamba2 engine's prefix hit decodes the tokens of a
                 cold start;
7. reduced train — reduced gemma-2b (head_dim 256) in fp32, same weights
                 (wq and wk conditioned, see ``conditioned``): three AdamW
                 steps on CUDA (the flash kernels) against the CPU (the
                 plain versions) within 1e-4, and on CUDA a save / restore
                 / resume that continues the loss;
8. full-width grads — gemma-2b at full width, 6 layers, fp32, 1 x 512
                 tokens: loss and every gradient leaf on CUDA (the kernels)
                 against the CPU (the plain versions) within 1e-4, with
                 conditioned wq/wk; for both initialisations it records the
                 plain versions against themselves on weights moved by half
                 an ulp, and attention alone at that initialisation's
                 scales, kernels and plain versions against float64;
9. serve       — qwen3-8b at full width and depth (36 layers, d 4096,
                 vocab 151936, bf16, random weights from a seed) through
                 ``ServeEngine`` with ``launch/serve.py``'s defaults, 8 requests
                 x 16 new tokens behind a shared 32-token head; every layer
                 of every model call launched the attention kernel;
10. ssm serve  — the same for mamba2-2.7b (64 layers, d 2560, 80 SSD heads
                 of 64, state 128, vocab 50280, bf16), after the qwen3-8b
                 engine is freed; every layer of every prefill chunk
                 launched the SSD kernel, and a prefix hit resumed from a
                 state page with zero copy bytes;
11. train      — gemma-2b at full width and depth (18 layers, d 2048, MQA
                 8/1 at head_dim 256, GeGLU d_ff 16384, vocab 256000, bf16,
                 ``remat="full"``, AdamW) through ``repro_torch.launch.train``:
                 4 steps of 4 x 2048 tokens, after the serving engines are
                 freed; every layer of every step launched the forward
                 kernel twice (forward and recompute) and each backward
                 kernel once.

Then a line ``{"kernels": [...]}`` with each kernel's launches, error and
times, the card's ``nvidia-smi`` name/power line, and last
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
HQ, HKV, D = 32, 8, 128
HBM_BYTES_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / fp32 (no TF32)
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# fp32: the kernel sums in another order than the plain version;
# bf16: about two bf16 ulps at magnitude 1 (both round the fp32 result
# once), the absolute part scaled by min(1, the case's max |out|)
SSD_H, SSD_P, SSD_N = 80, 64, 128   # mamba2-2.7b: 80 SSD heads of 64, state 128
SSD_CHUNK = 256                     # its ssm_chunk
SSD_TOL = 2e-4
# fp32 y and every final state: the reference's own SSD tolerance
# (tests/test_kernels.py), atol and rtol; bf16 y: rtol 2**-6 (two bf16 ulps
# of the value: both versions round one fp32 result once) and atol SSD_TOL
# times the largest |y| (fp32 sums taken in another order before rounding)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel cases at the main path's geometry
# ---------------------------------------------------------------------------


def make_case(torch, q_lens, kv_lens, dtype, *, extra_null=0, sparse=False,
              seed=0):
    """A ragged batch on a shuffled page pool: sequence s owns
    ceil(kv_lens[s] / PAGE) pages at random pool ids; page 0 stays the
    null page. ``extra_null`` pads every table row with trailing null
    slots; ``sparse`` nulls every other slot."""
    g = torch.Generator().manual_seed(seed)
    n_pages = [-(-k // PAGE) for k in kv_lens]
    W = max(n_pages) + extra_null
    P = 1 + sum(n_pages)
    perm = (1 + torch.randperm(P - 1, generator=g)).tolist()
    table = torch.zeros((len(kv_lens), W), dtype=torch.int32)
    for s, n in enumerate(n_pages):
        table[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    if sparse:
        table[:, 1::2] = 0
    pages = torch.randn((P, PAGE, 2 * HKV, D), generator=g)
    pages[0] = 0
    q = torch.randn((sum(q_lens), HQ, D), generator=g)
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
    item = q.element_size()
    cu_l, kl_l, tbl = cu.tolist(), kl.tolist(), table.tolist()
    row_bytes = 2 * HKV * D * item
    n_bytes = 2 * q.numel() * item + 4 * (table.numel() + cu.numel() + kl.numel())
    flops = 0
    for s, kv_len in enumerate(kl_l):
        qlen = cu_l[s + 1] - cu_l[s]
        for j, p in enumerate(tbl[s][:-(-kv_len // PAGE)]):
            if not p:
                continue
            n_bytes += row_bytes * (min(kv_len, (j + 1) * PAGE) - j * PAGE)
            flops += 4 * D * HQ * sum(
                max(0, min(kv_len - qlen + i + 1, (j + 1) * PAGE) - j * PAGE)
                for i in range(qlen))
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return (n_bytes, flops, max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    cu_l, kl_l = cu.tolist(), kl.tolist()
    S = len(kl_l)
    qmax = max(cu_l[s + 1] - cu_l[s] for s in range(S))
    L = max(kl_l)
    k = torch.zeros((S, HKV, L, D), dtype=q.dtype, device=q.device)
    v = torch.zeros_like(k)
    qq = torch.zeros((S, HQ, qmax, D), dtype=q.dtype, device=q.device)
    mask = torch.zeros((S, 1, qmax, L), dtype=torch.bool, device=q.device)
    for s in range(S):
        n = -(-kl_l[s] // PAGE)
        kv = pages[table[s, :n].long()].reshape(n * PAGE, 2 * HKV, D)[:kl_l[s]]
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
    scale = D ** -0.5
    decode = ([1, 1, 1, 1], [33, 77, 100, 128])
    mixed = ([5, 1, 48, 1], [37, 64, 80, 128])
    extend = ([48], [80])
    long = ([1, 1, 1, 1], [1000, 700, 1500, 333])   # more splits than one CTA takes
    cases = [("decode", decode, {}, {}),
             ("sparse_table", mixed, {"sparse": True}, {}),
             ("extend48", extend, {}, {}),
             ("decode_cap", decode, {}, {"cap": 30.0}),
             ("decode_window", decode, {}, {"window": 40}),
             ("extend48_cap_window", extend, {}, {"cap": 30.0, "window": 40}),
             ("long_decode", long, {}, {}),
             ("long_extend_window", ([20, 3], [1000, 600]), {}, {"window": 300}),
             # 128 pages and more: several slots a split
             ("multi_slot_splits", ([1, 3], [4500, 6000]), {}, {}),
             ("multi_slot_window", ([1, 20], [6000, 4200]), {}, {"window": 2500})]
    errs, atols = {}, {}
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, (ql, kl), mk, kw in cases:
            case = make_case(torch, ql, kl, dtype, **mk)
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
        for name, (ql, kl) in (("decode", decode), ("extend48", extend),
                               ("long_decode", long)):
            base = make_case(torch, ql, kl, dtype, seed=3)
            padded = make_case(torch, ql, kl, dtype, seed=3, extra_null=20)
            assert torch.equal(base[1], padded[1]) and torch.equal(base[0], padded[0])
            o0 = rpa(*base, scale=scale, max_q_len=max(ql))
            o4 = rpa(*padded, scale=scale, max_q_len=max(ql))
            if not torch.equal(o0, o4):
                raise AssertionError(f"{dname}/{name}: output changed under 20 "
                                     "trailing null table slots")
        # the last row of an extend launch (one CTA folds every group) and the
        # same row alone in a decode launch (the groups spread over CTAs)
        for kv_len in (80, 1000, 4500):
            q, pages, table, cu, kl = make_case(torch, [48], [kv_len], dtype, seed=4)
            ext = rpa(q, pages, table, cu, kl, scale=scale, max_q_len=48)
            one = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
            dec = rpa(q[-1:].contiguous(), pages, table, one, kl, scale=scale, max_q_len=1)
            if not torch.equal(ext[-1:], dec):
                raise AssertionError(f"{dname}: kv {kv_len}, a row's decode and "
                                     "extend launches differ")
    emit("kernel_check", kernel="ragged_paged_attention", max_abs_err=errs,
         tolerance={"rtol": TOL, "atol": atols}, padding_bit_equal=True,
         decode_equals_extend_row=True)

    # -- times at the main path's bf16 shapes ---------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for name, (ql, kl) in (("decode", ([1, 1, 1, 1], [72, 80, 88, 96])),
                           ("extend", ([48], [80])),
                           ("long_decode", ([1, 1, 1, 1], [4096] * 4))):
        case = make_case(torch, ql, kl, torch.bfloat16, seed=5)
        n_bytes, flops, bound_ms, bound_by = work(case, "bfloat16")
        qq, k, v, mask = sdpa_inputs(torch, case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qq, k, v, attn_mask=mask, scale=scale,  # noqa: E731
                           enable_gqa=True)
        kernel = lambda: rpa(*case, scale=scale, max_q_len=max(ql))  # noqa: E731
        timing[name] = {
            "q_lens": ql, "kv_lens": kl, "bytes": n_bytes, "flops": flops,
            "ms": time_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, lambda: rpa_ref(*case, scale=scale),
                                flush, iters=20),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # the card's time alone (main kernel and, when spread, the merge)
            "device_ms": device_ms(torch, kernel, flush,
                                   lambda key: "ragged_paged_attention" in key),
            "library_device_ms": device_ms(torch, lib, flush),
        }
    emit("kernel_time", kernel="ragged_paged_attention", dtype="bfloat16",
         nvidia_smi=smi, shapes=timing)
    return max_err, timing


# ---------------------------------------------------------------------------
# SSD chunk scan at the mamba2-2.7b path's geometry
# ---------------------------------------------------------------------------


def ssd_case(torch, S, dtype, *, B=1, H=SSD_H, P=SSD_P, N=SSD_N, G=1,
             state=True, seed=0):
    """Inputs drawn as the model forms them: x, b, c ~ N(0, 1) in the model
    dtype, dt ~ U[1e-3, 1e-1] and A ~ U[1, 16) (the initialisers' ranges),
    and a random fp32 carried state (or None: zeros)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g)
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((B, S, H), generator=g)
    a = -(1.0 + 15.0 * torch.rand((H,), generator=g))
    b = torch.randn((B, S, G, N), generator=g)
    c = torch.randn((B, S, G, N), generator=g)
    init = torch.randn((B, H, P, N), generator=g) if state else None
    return ([x.to(dtype).cuda(), dt.cuda(), a.cuda(), b.to(dtype).cuda(),
             c.to(dtype).cuda()], None if init is None else init.cuda())


def ssd_work(case, init, dtype_name, block=32):
    """(bytes, flops, bound_ms, bound_by) of the scan on this input: x, b,
    c, dt, a and the initial state read once, y and the final state written
    once; per (batch, head) and block of L tokens (the kernel's 32) the
    lower triangle of C.B^T (N*L*(L+1)) and of its product with x*dt
    (P*L*(L+1)), and the carried-state output and state update (2*L*P*N
    each)."""
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
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / PEAK_FLOPS["float32"]
    return (n_bytes, flops, max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ssd_kernel_phase(torch, sops, sref, smi):
    scan, plain = sops.ssd_scan, sref.ssd_scan_ref
    cases = [(f"S{S}_{'state' if st else 'zero'}", S, {"state": st})
             for S in (1, 9, 32) for st in (False, True)]
    cases += [("S512_multichunk", 512, {}),
              ("B2_G4_S40", 40, {"B": 2, "H": 8, "G": 4, "N": 64})]
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
    for S in (32, 9):
        case, init = ssd_case(torch, S, torch.bfloat16, seed=100 + S)
        n_bytes, flops, bound_ms, bound_by = ssd_work(case, init, "bfloat16")
        timing[f"S{S}"] = {
            "shape": [1, S, SSD_H, SSD_P, SSD_N], "bytes": n_bytes,
            "flops": flops,
            "ms": time_ms(torch, lambda: scan(*case, chunk=SSD_CHUNK,
                                              init_state=init), flush),
            "plain_ms": time_ms(torch, lambda: plain(*case, chunk=SSD_CHUNK,
                                                     init_state=init),
                                flush, iters=20),
            "library_ms": None,   # no single PyTorch call computes an SSD scan
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit("kernel_time", kernel="ssd_scan", dtype="bfloat16", nvidia_smi=smi,
         shapes=timing)
    return max_err, timing


# ---------------------------------------------------------------------------
# Flash attention at the training path's geometry
# ---------------------------------------------------------------------------

FA_CASES = [  # name, B, S, H, Hkv, D, cap, window
    ("gemma2b", 4, 2048, 8, 1, 256, None, None),
    ("qwen3_8b", 1, 2048, 32, 8, 128, None, None),
    ("cap50_window64", 2, 1024, 8, 1, 256, 50.0, 64),
    ("ragged_S1000", 2, 1000, 8, 1, 256, None, None),
    ("d64_gqa4_S300", 2, 300, 8, 2, 64, None, None),
    ("d32_mha_cap30", 2, 300, 4, 4, 32, 30.0, None),
    ("S17", 2, 17, 8, 1, 256, None, None),
    ("d64_S17_window5", 1, 17, 8, 1, 64, None, 5),
    ("d128_G3_S200", 2, 200, 6, 2, 128, None, None),   # G does not divide 64
]
# the redesigned bf16 kernels: wgmma (HGMMA) in the flash kernels, mma.sync
# (HMMA) in paged attention
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")
MMA_KERNELS = ("ragged_paged_attention_mma_kernel",)
FA_TOL = {"float32": {"values": 3e-5, "grads": 2e-4}, "bfloat16": 2e-2}
# fp32: the reference's own flash tolerances — values 3e-5 atol and rtol
# (tests/test_kernels.py), gradients 2e-4 (tests/test_models.py); sums run
# in another order. bf16: 2e-2 of the largest |value| (the reference's bf16
# flash tolerance, taken relative: gradients summed over 2048 rows grow
# well past 1, and each side rounds its own fp32 result to bf16).


def flash_case(torch, B, S, H, Hkv, D, dtype, seed=0):
    """q, k, v and the output cotangent dO, ~N(0, 1), on the card."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)]
    return [torch.randn(s, generator=g).to(dtype).cuda() for s in shapes]


def flash_work(B, S, H, Hkv, D, item):
    """(flops, bytes) of each kernel's function on these causal shapes:
    every input read once, every output written once; per visible (query,
    key) pair (S(S+1)/2 per head) and head, 2*D flops per matrix product —
    the forward does two (QKᵀ, PV), the dK/dV kernel four (QKᵀ, dO Vᵀ,
    Pᵀ dO, dSᵀ Q), the dQ kernel three (QKᵀ, dO Vᵀ, dS K)."""
    pairs = S * (S + 1) // 2 * B * H
    q = B * S * H * D * item
    kv = B * S * Hkv * D * item
    stats = B * H * S * 4
    return {"flash_attention_fwd": (4 * D * pairs, 2 * q + 2 * kv + 2 * stats),
            "flash_attention_bwd_dkdv": (8 * D * pairs, 2 * q + 4 * kv + 3 * stats),
            "flash_attention_bwd_dq": (6 * D * pairs, 3 * q + 2 * kv + 3 * stats)}


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
        for name, B, S, H, Hkv, D, cap, window in FA_CASES:
            q, k, v, do = flash_case(torch, B, S, H, Hkv, D, dtype)
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
    emit("kernel_check", kernel="flash_attention", max_abs_err=errs,
         tolerance={"float32": FA_TOL["float32"],
                    "bfloat16": "2e-2 of the largest |value|"},
         launches_bit_equal=True)

    # -- times at the gemma-2b training shape, bf16 ----------------------
    _, B, S, H, Hkv, D, _, _ = FA_CASES[0]
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
    for t in timing.values():
        t["tflops"] = t["flops"] / t["ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
    sdpa_fwd_ms = timing["flash_attention_fwd"]["library_ms"]
    emit("kernel_time", kernel="flash_attention", dtype="bfloat16",
         shape=[B, S, H, Hkv, D], causal=True, nvidia_smi=smi, kernels=timing,
         sdpa_forward_ms=sdpa_fwd_ms, sdpa_forward_backward_ms=sdpa_fwd_bwd_ms,
         sdpa_backward_ms=sdpa_fwd_bwd_ms - sdpa_fwd_ms, sdpa_device_kernels=backends,
         flash_backward_both_ms=timing["flash_attention_bwd_dkdv"]["ms"]
         + timing["flash_attention_bwd_dq"]["ms"],
         dkdv_unit_rows=fops.DKDV_UNIT_ROWS, dkdv_no_split_ms=no_split_ms)
    emit("kernel_accuracy", kernel="flash_attention", shape=[B, S, H, Hkv, D],
         **bf16_vs_float64(torch, fops, fref, q, k, v, do, scale))
    return max_err, timing


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
    to jax.random's: reduced qwen3-8b, mamba2-2.7b and gemma-2b at seed 3,
    every leaf bit for bit (the SSM initialisers' float32 log and expm1
    included). The launchers draw their weights on the card."""
    unequal, total = {}, {}
    for arch in ("qwen3-8b", "mamba2-2.7b", "gemma-2b"):
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
    the CPU path, same weights; then, on CUDA, an engine whose prefix hits
    resume from state pages decodes the tokens of a cold start."""
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

    runs = {}
    for name, flags in (("hit", []), ("cold", ["--no-prefix-caching"])):
        args = serve.parser().parse_args(["--arch", "mamba2-2.7b", *flags])
        eng = serve.build_engine(args, cfg, full, params, device="cuda")
        eng.ecfg.eos_token = -1
        prompts = serve.make_prompts(cfg, 4, 32, args.seed)
        eng.submit(prompts[0], max_new_tokens=6)
        eng.run_until_idle()
        for pr in prompts[1:]:
            eng.submit(pr, max_new_tokens=6)
        rep = eng.run_until_idle()
        runs[name] = ({k: list(v) for k, v in eng.outputs.items()}, rep)
    hits = runs["hit"][1]["prefix"]["compute_hits"]
    if runs["hit"][0] != runs["cold"][0] or hits < 1:
        raise AssertionError(f"reduced mamba2 on CUDA: prefix hit ({hits} "
                             "hits) does not decode the cold-start tokens")
    emit("reduced_model_check", arch="mamba2-2.7b", relative_logit_err=errs,
         tolerance=1e-4, hit_equals_cold=True, compute_hits=hits,
         prefill_tokens_skipped=runs["hit"][1]["prefill_tokens_skipped"])


# ---------------------------------------------------------------------------
# Main path at full width and depth
# ---------------------------------------------------------------------------


def run_serve(torch, cfg_mod, tfm, serve, param, arch, kernels):
    """Drive one serving path once at full width and depth: ``arch`` with
    nothing reduced, random weights from ``launch/serve.py``'s seed and
    defaults, 8 requests x 16 new tokens behind a shared 32-token
    head (the first alone, publishing the head; then the rest). Every
    kernel wrapper in ``kernels`` has its launch count set to 0 just before
    the run and read just after. Returns (cfg, report, launches, stats)."""
    cfg = cfg_mod.get_config(arch)           # nothing reduced
    args = serve.parser().parse_args(["--arch", arch])   # serve defaults
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in param.tree_leaves(params))
    eng = serve.build_engine(args, cfg, cfg, params, device="cuda")
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
    stats = dict(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
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
        prefill_tokens_skipped=rep["prefill_tokens_skipped"],
        compute_hits=rep["prefix"]["compute_hits"],
        snapshot_kind=rep["prefix"]["snapshot_kind"],
        kernel_read_bytes=rep["kernel_read_bytes"],
        seed_copy_bytes=rep["seed_copy_bytes"],
        finite_logits=bool(finite) and all(finite))
    return cfg, rep, launches, stats


def _require(phase: str, checks: dict) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


def serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi):
    """qwen3-8b: every layer of every model call launched the attention
    kernel."""
    cfg, rep, launches, st = run_serve(torch, cfg_mod, tfm, serve, param,
                                       "qwen3-8b", kernels)
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
                                       "mamba2-2.7b", kernels)
    n = launches["ssd_scan"]
    chunks = rep["prefill_chunks"]
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
    }
    emit("ssm_serve", nvidia_smi=smi, **st,
         state_page_bytes=cfg.ssm_state_bytes_layer(), checks=checks)
    _require("mamba2-2.7b serve", checks)
    return n


# ---------------------------------------------------------------------------
# Training: reduced gemma-2b CUDA vs CPU, then full width and depth
# ---------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)


def conditioned(tree, d_model):
    """``tree`` with every wq and wk rescaled to std d_model^-1/2. The
    reference's fan-in rule gives gemma-2b's single KV head wk std 1, so
    its attention scores have std ~sqrt(head_dim) and saturate; there fp32
    gradients are ill-conditioned and two sound implementations (the same
    function summed in another order) part after Adam's first step. With
    scores of std ~1 they agree to ~1e-6."""
    if isinstance(tree, dict):
        return {k: v * (d_model ** -0.5 / float(v.float().std()))
                if k in ("wq", "wk") else conditioned(v, d_model)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(conditioned(v, d_model) for v in tree)
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
    """gemma-2b at full width, 6 layers, fp32, one batch of 1 x 512 tokens:
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
    cfg = dataclasses.replace(cfg_mod.get_config("gemma-2b"), num_layers=6,
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


def main() -> int:
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
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli
    from repro_torch.models import param
    from repro_torch.models import transformer as tfm

    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sources = [ops.SOURCE, sops.SOURCE, fops.SOURCE]
    libs = _build.build_all(sources)
    build_s = time.perf_counter() - t0
    reports = {src.stem: _build.report(src) for src in sources}
    tensor_core = {name: {"hgmma": r.get("hgmma"), "hmma": r.get("hmma")}
                   for lib in ("flash_attention", "ragged_paged_attention")
                   for name, r in reports[lib].items()
                   if name.startswith(TC_KERNELS + MMA_KERNELS)}
    emit("build", kernels=["ragged_paged_attention", "ssd_scan", "flash_attention"],
         libraries=[str(lib.relative_to(ROOT)) for lib in libs], build_s=build_s,
         ptxas=reports, tensor_core_instructions=tensor_core)
    # where the toolkit has cuobjdump, each bf16 instantiation of the
    # redesigned kernels must run its products on the tensor cores
    _require("tensor-core build", {
        name: counts["hmma" if name.startswith(MMA_KERNELS) else "hgmma"] is None
        or counts["hmma" if name.startswith(MMA_KERNELS) else "hgmma"] > 0
        for name, counts in tensor_core.items()} | {"found": len(tensor_core) == 16})

    flash = [fops.flash_attention_fwd, fops.flash_attention_bwd_dkdv,
             fops.flash_attention_bwd_dq]
    kernels = [ops.ragged_paged_attention, sops.ssd_scan, *flash]
    max_err, timing = kernel_phase(torch, ops, ref, smi)
    ssd_err, ssd_timing = ssd_kernel_phase(torch, sops, sref, smi)
    fa_err, fa_timing = flash_kernel_phase(torch, fops, fref, smi)
    reduced_model_phase(torch, cfg_mod, tfm, param)
    reduced_ssm_phase(torch, cfg_mod, tfm, param, serve)
    init_device_phase(torch, cfg_mod, tfm, param)
    reduced_train_phase(torch, cfg_mod, tfm, param, optim, train, data, ckpt)
    full_width_grad_phase(torch, cfg_mod, tfm, param, optim, train, data, fops,
                          fref)
    rpa_launches = serve_phase(torch, cfg_mod, tfm, serve, param, kernels, smi)
    gc.collect()                     # the qwen3-8b engine and weights
    torch.cuda.empty_cache()
    ssd_launches = ssm_serve_phase(torch, cfg_mod, tfm, serve, param, kernels,
                                   smi)
    fa_launches = train_phase(torch, cfg_mod, train_cli, kernels, smi)

    dec, ssd = timing["decode"], ssd_timing["S32"]
    entries = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": str(ops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:225",
        "launches": rpa_launches, "max_abs_err": max_err["bfloat16"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": str(sops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:59",
        "launches": ssd_launches, "max_abs_err": ssd_err["bfloat16"],
        "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None}]
    replaces = {"flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:74",
                "flash_attention_bwd_dkdv": "src/repro/models/attention.py:126",
                "flash_attention_bwd_dq": "src/repro/models/attention.py:126"}
    for fn in flash:
        name, t = fn.__name__, fa_timing[fn.__name__]
        entries.append({
            "name": name, "route": "cuda", "source": str(fops.SOURCE.relative_to(ROOT)),
            "replaces": replaces[name], "launches": fa_launches[name],
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
