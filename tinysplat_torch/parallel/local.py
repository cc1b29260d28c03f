"""Run one program on N local ranks and collect each rank's result.

The port's stand-in for the JAX package's one-process virtual mesh: there
one process drives N (virtual) devices; in ``torch.distributed`` one rank
drives one device, so N ranks are N processes. ``run`` starts them (one
``python -m tinysplat_torch.parallel.local`` each), joins them into one
process group through a ``file://`` store under a temporary directory, runs
``fn(*args, **kwargs)`` on every rank and returns the results in rank order.

On the CPU the ranks use gloo. With ``device="cuda"`` each rank takes
``cuda:(rank % device_count)``; every rank gets LOCAL_RANK and
LOCAL_WORLD_SIZE, so ``init_distributed`` sees when more ranks than cards
share this host and then uses gloo with host staging (``collectives``), as
NCCL refuses two ranks on one card. The
parent builds the CUDA kernels before it starts the ranks, so that N ranks
do not each run nvcc.

``fn`` and its arguments go to the ranks by pickle, so ``fn`` must be a
module-level function of an importable module (the ranks get the parent's
``sys.path``). A rank that fails or outlives ``timeout`` stops every rank,
and ``run`` raises with the end of that rank's error output.

    python -m tinysplat_torch.parallel.local JOB RANK   # one rank (internal)
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence


def run(fn: Callable, world_size: int, args: Sequence = (), kwargs: Optional[dict] = None,
        device: str = "cuda", timeout: float = 600.0, threads: int = 1) -> List[Any]:
    """``fn(*args, **kwargs)`` on ``world_size`` local ranks; the results
    in rank order. ``threads``: torch threads per rank."""
    if device == "cuda":
        from ..ops import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="tinysplat_ranks_") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"fn": fn, "args": tuple(args), "kwargs": kwargs or {},
                         "world": world_size, "store": os.path.join(tmp, "store"),
                         "device": device, "threads": threads}, f)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        procs, logs = [], [os.path.join(tmp, f"rank{r}.log") for r in range(world_size)]
        try:
            for r, path in enumerate(logs):
                with open(path, "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "tinysplat_torch.parallel.local", job, str(r)],
                        env=dict(env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world_size)),
                        stdout=log, stderr=subprocess.STDOUT))
            _join(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.out"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _join(procs, logs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            r = failed[0]
            raise RuntimeError(f"rank {r} of {len(procs)} exited {codes[r]}:\n"
                               f"{_tail(logs[r])}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            live = [r for r, c in enumerate(codes) if c is None]
            raise TimeoutError(f"ranks {live} still running after {timeout} s:\n"
                               f"{_tail(logs[live[0]])}")
        time.sleep(0.05)


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _rank_main(job_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from .trainer import init_distributed

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    init_distributed(init_method=f"file://{job['store']}", rank=rank,
                     world_size=job["world"], device=job["device"])
    try:
        result = job["fn"](*job["args"], **job["kwargs"])
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(job_path), f"rank{rank}.out")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
