"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root and loaded with ``ctypes``.
The library's file name carries a hash of its source, of the shared
headers (``csrc/*.cuh``) and of its flags, so an edited source is rebuilt
and a stale library is never loaded. Several sources build in
parallel: one ``nvcc`` process each, all started together.

Every launch goes through :func:`launch`, which counts it in ``launches``
under its entry point's symbol (``launches["composite_fwd"]``): the one
count of which kernels ran, and how often, that the card's checks read.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("composite_fwd", "composite_bwd", "segsum", "probe_bitcast", "probe_op_costs",
           "splat_fwd", "splat_bwd", "binning", "ssim", "scatter_rows")
# Flags of one source only. The splat-input and binning kernels round every
# product and sum on its own, as the torch ops of their plain versions do
# (the binning kernels also spell each rounding out with intrinsics).
EXTRA_FLAGS = {"splat_fwd": ("-fmad=false",), "splat_bwd": ("-fmad=false",),
               "binning": ("-fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}
# Accepted launches by entry-point symbol. A viewer thread and the trainer's
# thread may both launch: ``launches[k] += 1`` may then lose a count, as any
# unlocked increment may; a diagnostic count takes no lock.
launches: Counter = Counter()
# A viewer thread and the trainer's thread may launch a kernel first at once.
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels build only on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, in parallel.

    Each build writes to a temporary file and renames it into place, so a
    concurrent loader never sees half a library. nvcc's output (with
    ptxas's register and spill report) is kept beside the library as
    ``<library>.log``. Raises with that output if a build fails.
    """
    names = list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            paths[name].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[name])
        else:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed; one
    thread builds and loads it, the others wait for that)."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
    return lib


@functools.cache
def function(name: str, symbol: str, argtypes: tuple):
    """C function ``symbol`` of source ``name``'s library with its ctypes
    signature, returning an int; the library is built on first use."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, device, *args, symbol: str = "") -> None:
    """Launch entry point ``symbol`` (default: ``name``) of source ``name``
    on ``device``'s current stream (passed as the last argument) and count
    it in ``launches[symbol]``; raises, and counts nothing, if the launch
    was refused (every entry point returns cudaGetLastError())."""
    import torch

    symbol = symbol or name
    fn = function(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    launches[symbol] += 1
