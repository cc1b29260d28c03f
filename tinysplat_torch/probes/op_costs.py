"""P2: what each elementwise op, and each route of a triangular product,
costs inside a kernel on the card (probe).

Counterpart of ``scripts/probe_vpu_costs.py``: the hand-written kernel
``csrc/probe_op_costs.cu`` runs ``ITERS`` = 512 dependent iterations of one
op over a (128, L) f32 tile, 4 independent chains per element, for every
row of the JAX probe's ``OPS``; and 512 passes of x <- (T x) * 1e-3 (T the
128 x 128 lower-triangular ones) by FFMA, one bf16 ``mma.sync`` pass, or
the hi + lo bf16 split. ``exp`` is ``expf`` and ``div`` ``__fdiv_rn``, as in
K1 and K2, so the rows time the instructions the compositing kernels execute.

    python -m tinysplat_torch.probes.op_costs [--lanes 256] [--wide-lanes 33792] \
        [--device cuda]

prints, per row and width, ns per pass, the ratio to ``fma`` and the row's
bound from the card's instruction throughputs (stated with the SM clock used), and
whether the kernel equals its plain version within the row's tolerance.
L = 256 launches only 32,768 threads; ``--wide-lanes`` (default 132 x 256)
fills the 132 SMs.

``probe_op_costs`` launches the kernel on CUDA tensors and runs
``probe_op_costs_plain`` (the same loop in torch float32) on CPU tensors.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Dict, Optional

import torch

from ..ops import _build
from . import timed_ms

S = 128  # tile rows (and the triangular matrix's size)
ITERS = 512
CHAINS = 4
STRIP = 64  # columns per block of the triangular rows
OPS = ("fma", "mul2", "exp", "exp2", "log2", "div", "recip", "cmp_sel", "min", "bf16_split",
       "tri_matmul", "tri_highest", "tri_x2_manual")
TRI = ("tri_matmul", "tri_highest", "tri_x2_manual")

# Kernel vs plain version, as max|kernel - plain| / max|plain|.
#  - 0 (bit for bit): every op is one IEEE-rounded operation in the plain
#    version's order (products, sums, __fdiv_rn, __frcp_rn, the compare and
#    the bf16 round-to-nearest-even).
#  - fma: one rounding (fmaf) on the card, two in the plain version; the map
#    does not contract, so 512 iterations add up to ~512 half-ulps.
#  - exp, exp2, log2: libm routines of at most 2 ulp on both sides, which
#    may differ; the maps are contractive, so the difference does not grow.
#  - tri_*: the row sums run in another order (tensor-core or FFMA order
#    vs the plain matmul's); held after ONE pass, since after ~30 passes
#    the values underflow to 0 (x 1e-3 each pass) and the 512-pass outputs
#    are 0 on both sides.
TOLERANCE = {"fma": 1e-4, "exp": 1e-6, "exp2": 1e-6, "log2": 1e-6,
             "tri_matmul": 1e-5, "tri_highest": 1e-5, "tri_x2_manual": 1e-5}

# Results per SM per clock (CUDA C++ Programming Guide, throughput of
# native arithmetic instructions, compute capability 9.0) and the instructions
# each elementwise row needs per element and iteration, at the least:
# (FP32 pipe, special-function unit, type conversion).
FP32_PER_CLK, SFU_PER_CLK, CVT_PER_CLK = 128, 16, 16
INSTRUCTIONS = {
    "fma": (1, 0, 0),         # FFMA
    "mul2": (2, 0, 0),        # 2 FMUL
    "exp": (2, 1, 0),         # FMUL by 1e-6, FMUL by log2(e), MUFU.EX2
    "exp2": (1, 1, 0),        # FMUL, MUFU.EX2
    "log2": (1, 1, 0),        # FADD, MUFU.LG2
    "div": (2, 1, 0),         # FADD, MUFU.RCP, FMUL (before Newton steps)
    "recip": (1, 1, 0),       # FADD, MUFU.RCP
    "cmp_sel": (4, 0, 0),     # FSETP, FMUL, FADD, select
    "min": (2, 0, 0),         # FMUL, FMNMX
    "bf16_split": (4, 0, 1),  # FMUL, FMUL, FSUB, FADD; f32 -> bf16
}
# The triangular rows' dense peaks (H100 SXM data sheet, 700 W).
TRI_FLOPS_PER_S = {"tri_highest": 67e12, "tri_matmul": 989e12, "tri_x2_manual": 989e12 / 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = (_I, _P, _P, _I, _I, _I, _P)

OP_FNS = {
    "fma": lambda x: x * 1.000001 + 1e-8,
    "mul2": lambda x: (x * 1.000001) * 0.999999,
    "exp": lambda x: torch.exp(-torch.abs(x) * 1e-6),
    "exp2": lambda x: torch.exp2(-torch.abs(x) * 1e-6),
    "log2": lambda x: torch.log2(torch.abs(x) + 1.0),
    "div": lambda x: x / (torch.abs(x) + 1.0),
    "recip": lambda x: 1.0 / (torch.abs(x) + 1.0),
    "cmp_sel": lambda x: torch.where(x > 0.5, x * 0.999, x + 1e-7),
    "min": lambda x: torch.clamp(x * 1.000001, max=2.0),
    "bf16_split": lambda x: (x.to(torch.bfloat16).float() * 1.000001
                             + 1e-8 * (x - x.to(torch.bfloat16).float())),
}


def _check(op: str, x: torch.Tensor, iters: int) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"x must be a contiguous 2-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)} (contiguous {x.is_contiguous()})")
    if op in TRI and (x.shape[0] != S or x.shape[1] % STRIP):
        raise ValueError(f"{op} takes ({S}, L) with L % {STRIP} == 0, got {tuple(x.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def probe_op_costs(op: str, x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Row ``op`` of the probe on the (rows, L) tile ``x``: the sum of the 4
    chains after ``iters`` iterations (elementwise rows), or x after
    ``iters`` triangular passes.

    Launches the kernel on CUDA tensors (``_build.launches["probe_op_costs"]``
    counts the launches) and runs ``probe_op_costs_plain`` on CPU tensors.
    """
    _check(op, x, iters)
    if x.device.type == "cpu":
        return probe_op_costs_plain(op, x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"probe_op_costs runs on CUDA or CPU tensors, not {x.device}")
    out = torch.empty_like(x)
    _build.launch("probe_op_costs", _SIGNATURE, x.device, OPS.index(op), x.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[1], iters)
    return out


def _tri(x: torch.Tensor) -> torch.Tensor:
    return torch.tril(torch.ones((S, S), dtype=torch.float32, device=x.device))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def probe_op_costs_plain(op: str, x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """The probe in plain PyTorch float32 (one torch op per rounding; the
    matrix products with TF32 off)."""
    _check(op, x, iters)
    if op in TRI:
        tri = _tri(x)
        with _no_tf32():
            for _ in range(iters):
                if op == "tri_highest":
                    y = tri @ x
                elif op == "tri_matmul":
                    y = tri @ _bf16(x)
                else:
                    hi = _bf16(x)
                    y = tri @ hi + tri @ _bf16(x - hi)
                x = y * 1e-3
        return x
    fn = OP_FNS[op]
    xs = [x * (1.0 + 0.001 * c) for c in range(CHAINS)]
    for _ in range(iters):
        xs = [fn(v) for v in xs]
    return ((xs[0] + xs[1]) + xs[2]) + xs[3]


class _no_tf32:
    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def tile(lanes: int, device) -> torch.Tensor:
    """The JAX probe's input: linspace(0.1, 1.9) over a (128, lanes) tile."""
    return torch.linspace(0.1, 1.9, S * lanes, dtype=torch.float32).reshape(S, lanes).to(device)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref| (ref's max floored at 1e-30)."""
    diff = float((got - ref).abs().max())
    return diff / max(float(ref.abs().max()), 1e-30)


def sm_clock_mhz() -> Optional[float]:
    """The card's maximum SM clock (nvidia-smi), in MHz; None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def bound_ms(op: str, lanes: int, sms: int, clock_hz: float, iters: int = ITERS) -> float:
    """The least time of one call of row ``op`` at (128, lanes)."""
    if op in TRI:
        return 2.0 * S * S * lanes * iters / TRI_FLOPS_PER_S[op] * 1e3
    fp32, sfu, cvt = INSTRUCTIONS[op]
    per_elem = iters * CHAINS * max(fp32 / FP32_PER_CLK, sfu / SFU_PER_CLK, cvt / CVT_PER_CLK)
    return S * lanes * per_elem / (sms * clock_hz) * 1e3


def run(device="cuda", lanes: int = 256, wide_lanes: int = 132 * 256, reps: int = 10,
        plain_reps: int = 3) -> Dict[str, dict]:
    """Every row: held against the plain version (tri rows also after one
    pass); on a CUDA device timed at ``lanes`` and ``wide_lanes`` with its
    bound. Prints one line per row and width; returns the results."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    widths = (lanes, wide_lanes) if dev.type == "cuda" else ()  # times only on the card
    clock = sms = None
    if dev.type == "cuda":
        clock = sm_clock_mhz() or 1980.0
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"bounds at {sms} SMs x {clock:.0f} MHz (nvidia-smi clocks.max.sm): "
              f"{FP32_PER_CLK} FP32 / {SFU_PER_CLK} SFU / {CVT_PER_CLK} conversion results "
              "per clock per SM", flush=True)
    results: Dict[str, dict] = {}
    for op in OPS:
        res = results[op] = {}
        x = tile(lanes, dev)
        got, ref = probe_op_costs(op, x), probe_op_costs_plain(op, x)
        res["err"] = rel_err(got, ref)
        if op in TRI:
            res["err_one_pass"] = rel_err(probe_op_costs(op, x, 1), probe_op_costs_plain(op, x, 1))
        tol = TOLERANCE.get(op, 0.0)
        res["tol"] = tol
        res["ok"] = max(res["err"], res.get("err_one_pass", 0.0)) <= tol
        res["max_abs_err"] = float((got - ref).abs().max())
        line = (f"{op:13s}: vs plain {res['err']:.3e}"
                + (f" (one pass {res['err_one_pass']:.3e})" if op in TRI else "")
                + f", tol {tol:g}, ok={res['ok']}")
        for w in widths:
            xw = tile(w, dev)
            passes = ITERS * (1 if op in TRI else CHAINS)
            ms = timed_ms(lambda: probe_op_costs(op, xw), reps, device_only=True)
            plain_ms = timed_ms(lambda: probe_op_costs_plain(op, xw), plain_reps, True)
            b = bound_ms(op, w, sms, clock * 1e6)
            res[w] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                      "ns_per_pass": ms * 1e6 / passes}
            rel = res[w]["ns_per_pass"] / results["fma"][w]["ns_per_pass"]
            line += (f"; L={w}: {res[w]['ns_per_pass']:.3f} ns/pass ({rel:.2f}x fma), "
                     f"{ms:.4f} ms vs bound {b:.4f} ms, plain {plain_ms:.2f} ms")
        print(line, flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lanes", type=int, default=256)
    p.add_argument("--wide-lanes", type=int, default=132 * 256)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.device, args.lanes, args.wide_lanes, args.reps)


if __name__ == "__main__":
    main()
