#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each printing one JSON line:

1. device  — requires CUDA; the card's name and power limit (nvidia-smi);
2. build   — builds every kernel of the main path from ``src/`` with nvcc
             into ``build/repro_torch_kernels/``;
3. kernel  — holds each kernel against its plain PyTorch version at the
             main path's geometry (fp32 and bf16, decode / sparse table /
             extend / softcap / window), checks bit-equality under trailing
             null table slots, checks the model's paged steps on a reduced
             fp32 config against the CPU path, and times the kernel, its
             plain version and one PyTorch library call (CUDA events);
4. serve   — drives the main path once at full width and depth:
             qwen3-8b (36 layers, d 4096, vocab 151936, bf16, random weights
             from a seed) served through ``ServeEngine`` with the serve
             driver's defaults, 8 requests x 16 new tokens behind a shared
             32-token head; checks the results and that every layer of every
             model call launched the kernel.

Then a line ``{"kernels": [...]}`` with each kernel's launches, error and
times, the card's ``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero and prints no result line. It imports nothing of JAX.
"""
from __future__ import annotations

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
# bf16: about two bf16 ulps at magnitude 1 (both round the fp32 result once)


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
    cases = [("decode", decode, {}, {}),
             ("sparse_table", mixed, {"sparse": True}, {}),
             ("extend48", extend, {}, {}),
             ("decode_cap", decode, {}, {"cap": 30.0}),
             ("decode_window", decode, {}, {"window": 40}),
             ("extend48_cap_window", extend, {}, {"cap": 30.0, "window": 40})]
    errs = {}
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
            if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
                raise AssertionError(f"{dname}/{name}: kernel vs plain max abs "
                                     f"err {err} over tolerance {tol}")
        for name, (ql, kl) in (("decode", decode), ("extend48", extend)):
            base = make_case(torch, ql, kl, dtype, seed=3)
            padded = make_case(torch, ql, kl, dtype, seed=3, extra_null=4)
            assert torch.equal(base[1], padded[1]) and torch.equal(base[0], padded[0])
            o0 = rpa(*base, scale=scale, max_q_len=max(ql))
            o4 = rpa(*padded, scale=scale, max_q_len=max(ql))
            if not torch.equal(o0, o4):
                raise AssertionError(f"{dname}/{name}: output changed under 4 "
                                     "trailing null table slots")
    emit("kernel_check", kernel="ragged_paged_attention", max_abs_err=errs,
         tolerance=TOL, padding_bit_equal=True)

    # -- times at the main path's bf16 shapes ---------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for name, (ql, kl) in (("decode", ([1, 1, 1, 1], [72, 80, 88, 96])),
                           ("extend", ([48], [80]))):
        case = make_case(torch, ql, kl, torch.bfloat16, seed=5)
        n_bytes, flops, bound_ms, bound_by = work(case, "bfloat16")
        qq, k, v, mask = sdpa_inputs(torch, case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qq, k, v, attn_mask=mask, scale=scale,  # noqa: E731
                           enable_gqa=True)
        timing[name] = {
            "q_lens": ql, "kv_lens": kl, "bytes": n_bytes, "flops": flops,
            "ms": time_ms(torch, lambda: rpa(*case, scale=scale,
                                             max_q_len=max(ql)), flush),
            "plain_ms": time_ms(torch, lambda: rpa_ref(*case, scale=scale),
                                flush, iters=20),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit("kernel_time", kernel="ragged_paged_attention", dtype="bfloat16",
         nvidia_smi=smi, shapes=timing)
    return max_err, timing


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
    emit("reduced_model_check", relative_logit_err=errs, tolerance=1e-4)


# ---------------------------------------------------------------------------
# Main path at full width and depth
# ---------------------------------------------------------------------------


def serve_phase(torch, cfg_mod, tfm, serve, ops, param, smi):
    full = cfg_mod.get_config("qwen3-8b")
    cfg = full                               # nothing reduced
    args = serve.parser().parse_args([])     # the serve driver's defaults
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
    torch.cuda.reset_peak_memory_stats()
    ops.ragged_paged_attention.launches = 0
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
    launches = ops.ragged_paged_attention.launches
    calls = eng.backend.model_calls

    checks = {
        "finished": rep["finished"] == 8,
        "tokens_generated": rep["tokens_generated"] == 8 * args.max_new,
        "finite_logits": bool(finite) and all(finite),
        "launches": launches == cfg.num_layers * calls and calls > 0,
        "seed_copy_bytes": rep["seed_copy_bytes"] == 0,
        "kernel_read_bytes": rep["kernel_read_bytes"] > 0,
        "compute_hits": rep["prefix"]["compute_hits"] >= 1,
    }
    decode_tokens = rep["tokens_generated"] - rep["finished"]
    emit("serve", nvidia_smi=smi, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=cfg.dtype, weight_bytes=weight_bytes,
         init_s=init_s, first_request_s=first_s, wall_s=wall_s,
         decode_s=decode_s[0], decode_tokens=decode_tokens,
         decode_tokens_per_s=decode_tokens / decode_s[0],
         tokens_per_s=rep["tokens_generated"] / wall_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         model_calls=calls, kernel_launches=launches,
         finished=rep["finished"], tokens_generated=rep["tokens_generated"],
         prefill_chunks=rep["prefill_chunks"],
         prefill_tokens_skipped=rep["prefill_tokens_skipped"],
         compute_hits=rep["prefix"]["compute_hits"],
         kernel_read_bytes=rep["kernel_read_bytes"],
         seed_copy_bytes=rep["seed_copy_bytes"], checks=checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch import configs as cfg_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.launch import serve
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
    lib = _build.build(ops.SOURCE)
    emit("build", kernel="ragged_paged_attention",
         library=str(lib.relative_to(ROOT)), build_s=time.perf_counter() - t0)

    max_err, timing = kernel_phase(torch, ops, ref, smi)
    reduced_model_phase(torch, cfg_mod, tfm, param)
    launches = serve_phase(torch, cfg_mod, tfm, serve, ops, param, smi)

    dec = timing["decode"]
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": str(ops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/paged_attention/kernel.py:225",
        "launches": launches, "max_abs_err": max_err["bfloat16"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"]}]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
