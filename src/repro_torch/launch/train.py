"""Training entry point of the PyTorch port: data pipeline -> train step ->
checkpoint/restart, with the fault-tolerance control loop (heartbeats,
elastic re-mesh planning, straggler policy) wired in. Same flags, log
lines and final JSON line as ``repro.launch.train``, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --reduced --steps 50 --seq-len 128 --batch 8 --ckpt-dir /tmp/ckpt

Every architecture of the reference trains: dense, MoE (the aux loss in
the loss), MLA, SSM, hybrid, multi-codebook audio (the pipeline's (B, S,
K) batches) and the vision stack, on text batches as the reference's
launcher trains it (``loss_and_metrics`` takes image embeds from a batch
that has them). On the card every attention layer runs the hand-written
flash kernels (MLA's at Dk 192, Dv 128): the forward in the forward pass
(and again in the rematerialised recompute), the dK/dV and dQ kernels in
the backward; every SSM layer runs the SSD kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' raises without a card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--compress", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a worker failure at this step (FT test)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    import torch

    from repro_torch import ckpt as ckpt_lib
    from repro_torch.configs import get_config, reduced as reduce_cfg
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import OptConfig, adamw_update, init_opt_state
    from repro_torch.optim.compress import compress_decompress, init_state as comp_init
    from repro_torch.runtime.fault_tolerance import ClusterState
    from repro_torch.train import make_train_step
    from repro_torch.train.step import value_and_grad

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    oc = OptConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)

    pipeline = SyntheticPipeline(cfg, DataConfig(
        seq_len=args.seq_len, global_batch=args.batch, seed=args.seed))

    params = init_params(cfg, args.seed, device=dev)
    opt_state = init_opt_state(params)
    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt_lib.latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt_state), extra = ckpt_lib.restore(
                args.ckpt_dir, last, (params, opt_state))
            start_step = extra.get("step", last)
            print(f"[train] resumed from step {start_step}")

    train_step = make_train_step(cfg, oc)
    comp_state = comp_init(params) if args.compress != "none" else None

    def step_fn(params, opt_state, comp_state, batch):
        if comp_state is None:
            params, opt_state, metrics = train_step(params, opt_state, batch)
            return params, opt_state, None, metrics
        loss, metrics, grads = value_and_grad(cfg, params, batch)
        grads, comp_state = compress_decompress(grads, comp_state, args.compress)
        params, opt_state, stats = adamw_update(oc, params, grads, opt_state)
        return params, opt_state, comp_state, dict(metrics, loss=loss, **stats)

    cluster = ClusterState(workers=[f"w{i}" for i in range(4)], chips_per_worker=1)
    history = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipeline.batch_at(step).items()}
        ts = time.time()
        params, opt_state, comp_state, metrics = step_fn(params, opt_state,
                                                         comp_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - ts

        # fault-tolerance control loop (simulated single-host: all workers
        # report the measured step time; failure injection drops one)
        now = time.time() - t0
        times = {w: dt for w in cluster.workers}
        if args.inject_failure_at >= 0 and step == args.inject_failure_at:
            print(f"[ft] injecting failure of w0 at step {step}")
            if "w0" not in cluster.evicted:
                cluster.evicted.append("w0")
            for w in cluster.workers[1:]:
                cluster.monitor.beat(w, now)
        else:
            for w in cluster.workers:
                if w not in cluster.evicted:
                    cluster.monitor.beat(w, now)
        plan = cluster.handle_step(now, times)
        if plan is not None:
            print(f"[ft] re-mesh plan: {plan}")
            if args.ckpt_dir:
                ckpt_lib.save(args.ckpt_dir, step, (params, opt_state),
                              extra={"step": step})
                print(f"[ft] checkpointed at step {step} for elastic restart")

        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "dt_s": dt})
            print(f"step {step:5d} loss {loss:.4f} "
                  f"grad_norm {gnorm:.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt*1e3:.0f} ms)")
        if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
            ckpt_lib.save_async(args.ckpt_dir, step, (params, opt_state),
                                extra={"step": step})
    print(json.dumps({"final_loss": history[-1]["loss"] if history else None,
                      "steps": args.steps, "wall_s": time.time() - t0}))
    return history


if __name__ == "__main__":
    main()
