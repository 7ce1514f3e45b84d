"""PyTorch/CUDA port of the MRM serving system (``repro``) for one NVIDIA
Hopper card. Modules keep ``repro``'s names and layout; every TPU kernel on
a ported path is a hand-written Hopper kernel under ``kernels/``."""
