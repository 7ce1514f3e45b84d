"""Hand-written Hopper (sm_90a) kernels for the compute hot-spots, each
beside its plain PyTorch version.

Each kernel package has:
- ``csrc/*.cu`` — the CUDA C++ source, built with nvcc on first use
  (``kernels/_build.py``) and bound through ctypes;
- ``ops.py``    — the wrapper: checks, launch, launch count; tensors on
  the CPU take the plain version;
- ``ref.py``    — the plain PyTorch version (CPU path and oracle).
"""
