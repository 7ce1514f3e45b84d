"""Set-up seconds: process start (the first line of ``bench/run.py``) to
the window's start — CUDA context, kernel libraries, weights drawn on the
card, engine, warm-up with the cell's own traffic."""


def read(run):
    return run.setup_s
