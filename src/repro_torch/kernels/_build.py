"""Build and load the port's CUDA kernels.

Each kernel library is one ``csrc/*.cu`` file with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library at first
use and loaded with ``ctypes``. The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash of
its source and flags, so an edited source rebuilds and an unchanged one is
reused. A failed build raises; nothing falls back. ptxas's resource report
(``-Xptxas -v``) is kept beside each library (``.log``), and ``report``
reads it with the library's SASS: registers, spills and tensor-core
instructions per kernel.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under the CUDA home
    PyTorch was built against."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_all(sources) -> list:
    """Compile every source in ``sources`` whose library does not exist
    yet, one ``nvcc`` process per source, all started together; returns
    the libraries' paths in order. Raises with the compiler's output if
    any build fails; every process started is waited for or killed."""
    sources = [pathlib.Path(s) for s in sources]
    outs = [library_path(s) for s in sources]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src, out in zip(sources, outs):
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs.append((src, out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, out, tmp, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}) building "
                              f"{src.name}:\n{stdout}\n{stderr}")
            else:
                out.with_suffix(".log").write_text(stdout + stderr)
                os.replace(tmp, out)   # atomic: a concurrent build never sees a torn file
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return outs


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` unless its library already exists; returns the
    library's path. Raises with the compiler's output on failure."""
    return build_all([source])[0]


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library compiled from
    ``source``, a path to a ``.cu`` file. One handle per process."""
    return ctypes.CDLL(str(build(pathlib.Path(source))))


def _demangle(names):
    """Readable kernel names (``cu++filt`` of the toolkit; the mangled
    names where it is missing)."""
    filt = pathlib.Path(_nvcc()).with_name("cu++filt")
    if not filt.exists():
        return {n: n for n in names}
    res = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                         text=True, check=True)
    out = {}
    for n, d in zip(names, res.stdout.splitlines()):
        d = d.replace("(int)", "").replace("(bool)0", "false").replace("(bool)1", "true")
        m = re.search(r"(\w+(?:<[^()]*>)?)\(", d)
        out[n] = m.group(1) if m else d
    return out


def report(source) -> dict:
    """Per kernel of ``source``'s built library: registers, static shared
    bytes, stack and spill bytes (ptxas's report kept at build time), and
    the count of HGMMA (wgmma) and HMMA (mma.sync) instructions in its
    SASS (``cuobjdump -sass``; absent where the toolkit has no cuobjdump)."""
    lib = library_path(pathlib.Path(source))
    log = lib.with_suffix(".log")
    kernels, cur = {}, None
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(sm.group(1)) if sm else 0
    dump = pathlib.Path(_nvcc()).with_name("cuobjdump")
    if dump.exists():
        sass = subprocess.run([str(dump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split(None, 1)[0]
            k = kernels.setdefault(name, {})
            k["hgmma"] = chunk.count("HGMMA")
            k["hmma"] = len(re.findall(r"\bHMMA\b", chunk))
    names = _demangle(sorted(kernels))
    return {names[n]: kernels[n] for n in sorted(kernels)}
