"""End-to-end training driver example on the PyTorch port
(``examples/train_tiny_lm.py`` through ``repro_torch.launch.train``): train
a small language model with checkpointing, then resume — exercising the
data pipeline, AdamW, chunked-CE loss, remat, and the FT control loop, on
the card's flash kernels.

Run:  PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps 300]
      [--device cpu]
"""
import argparse
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    history = train_mod.main([
        "--arch", args.arch, "--reduced", "--device", args.device,
        "--steps", str(args.steps),
        "--seq-len", "128", "--batch", "8",
        "--lr", "1e-3", "--warmup", "40",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "20",
    ])
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss: {first:.3f} -> {last:.3f} over {args.steps} steps")
    assert last < first, "training failed to reduce loss"

    print("\n-- resuming from the checkpoint for 20 more steps --")
    resumed = train_mod.main([
        "--arch", args.arch, "--reduced", "--device", args.device,
        "--steps", str(args.steps + 20),
        "--seq-len", "128", "--batch", "8",
        "--ckpt-dir", args.ckpt_dir, "--resume", "--log-every", "10",
    ])
    return history, resumed


if __name__ == "__main__":
    main()
