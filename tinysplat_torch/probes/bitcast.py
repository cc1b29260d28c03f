"""P1: is f32 carried exactly through packed bf16 / u16 lanes? (probe)

Counterpart of ``scripts/probe_bf16_bitcast.py``: the hand-written kernel
``csrc/probe_bitcast.cu`` rebuilds f32 from 16-bit halves (variants A-D),
packs f32 into halves (E) and copies a u16 window from a dynamic row
offset through shared memory with ``cp.async`` (F). It answers whether a
half-width entry table would carry K1's and K2's positions and conics bit
for bit.

    python -m tinysplat_torch.probes.bitcast [--rows 760000] [--device cuda]

prints one line per variant: exact or not against the numpy ground truth
at the JAX probe's (8, 128) shape, equal or not to the plain version, and,
at a table of ``--rows`` rows x 16 f32 lanes (the 64 B of real data per
entry row; 760,000 rows is the bench frame's entry budget), the kernel's
time beside its bytes bound.

u16 lanes travel in ``torch.int16`` tensors (the same bits; torch's uint16
has few operations); bf16 colours come back as ``torch.bfloat16``.
``probe_bitcast`` launches the kernel on CUDA tensors and runs
``probe_bitcast_plain`` on CPU tensors.
"""
from __future__ import annotations

import argparse
import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import _build
from . import timed_ms

S, L = 8, 128  # the JAX probe's shape: rows x f32 lanes
WINDOW_ROWS = 32  # F's window
WINDOW_SRC = (256, 128)  # F's source, (rows, u16 lanes)
WINDOW_OFFSETS = (0, 3, 17, 200)
TABLE_LANES = 16  # 64 B of f32 per entry row
VARIANTS = ("A", "B", "C", "D", "E", "F")
NAMES = {"A": "A reshape+bitcast", "B": "B strided pairs", "C": "C packed halves",
         "D": "D uint16 window", "E": "E f32->u16 pack", "F": "F u16 dyn-offset window"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = (_I, _P, _P, _P, _LL, _I, _P, _I, _I, _P)


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int16-carried u16 lanes -> int32 values in [0, 65535]."""
    return x.to(torch.int32) & 0xFFFF


def _to_i16(v: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> the same 16 bits in int16."""
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16)


def _f32_from_halves(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi << 16) | lo of u16 values (int32), reinterpreted as f32."""
    word = (hi.to(torch.int64) << 16) | lo.to(torch.int64)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32).view(torch.float32)


def _check(variant: str, x: torch.Tensor, offsets) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    want = torch.float32 if variant == "E" else torch.int16
    if x.dtype != want or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"variant {variant} takes a contiguous 2-D {want} tensor, got "
                        f"{x.dtype} {tuple(x.shape)} (contiguous {x.is_contiguous()})")
    if variant != "F" and x.shape[1] % (8 if variant == "E" else 16):
        raise ValueError(f"variant {variant} takes rows of a multiple of 8 f32 lanes (16 "
                         f"u16 lanes), got {tuple(x.shape)}")
    if variant == "F":
        if x.shape[1] % 8 or WINDOW_ROWS * x.shape[1] * 2 > 48 * 1024:
            raise ValueError(f"F copies rows of a multiple of 8 u16 lanes (16 B) and at most "
                             f"48 KB a window, got {x.shape[1]} lanes")
        if x.shape[0] < WINDOW_ROWS:
            raise ValueError(f"F's source needs at least {WINDOW_ROWS} rows, got {x.shape[0]}")
        if (offsets.dtype != torch.int32 or offsets.dim() != 1
                or offsets.device != x.device):
            raise TypeError(f"window offsets must be a 1-D int32 tensor on {x.device}, got "
                            f"{offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")


def window_offsets(offsets: Sequence[int], device) -> torch.Tensor:
    """F's window offsets as the int32 tensor the probe takes."""
    return torch.tensor(list(offsets), dtype=torch.int32, device=device)


def probe_bitcast(variant: str, x: torch.Tensor, offsets: torch.Tensor = None):
    """Variant ``variant`` of the probe on ``x``:

    A, B: (S, 2L) int16 interleaved (lo, hi) pairs -> (S, L) f32;
    C: (S, 2L) int16 halves (lo lanes, then hi lanes) -> (S, L) f32;
    D: as C -> ((S, L) f32, (S, L) bf16 colours = the hi lanes);
    E: (S, L) f32 -> (S, 2L) int16 halves;
    F: (N, W) int16 source -> (K, 32, W) windows at ``offsets``, a (K,)
    int32 tensor on x's device (default: the JAX probe's 0, 3, 17, 200),
    each clamped to [0, N - 32].

    L is a multiple of 8 (F: W of 8). Launches the kernel on CUDA tensors
    starting on a 16-byte boundary (``_build.launches["probe_bitcast"]``
    counts the launches) and runs ``probe_bitcast_plain`` on CPU tensors.
    """
    if variant == "F" and offsets is None:
        offsets = window_offsets(WINDOW_OFFSETS, x.device)
    _check(variant, x, offsets)
    if x.device.type == "cpu":
        return probe_bitcast_plain(variant, x, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"probe_bitcast runs on CUDA or CPU tensors, not {x.device}")
    if x.data_ptr() % 16:  # the kernel moves 16-byte chunks
        raise ValueError("probe_bitcast needs x to start on a 16-byte boundary")
    dev = x.device
    rows = x.shape[0]
    lanes = x.shape[1] if variant in "EF" else x.shape[1] // 2
    out2 = None
    off_t = offsets.contiguous() if variant == "F" else x  # unread unless F
    if variant == "E":
        out = torch.empty((rows, 2 * lanes), dtype=torch.int16, device=dev)
    elif variant == "F":
        out = torch.empty((off_t.shape[0], WINDOW_ROWS, lanes), dtype=torch.int16, device=dev)
    else:
        out = torch.empty((rows, lanes), dtype=torch.float32, device=dev)
        if variant == "D":
            out2 = torch.empty((rows, lanes), dtype=torch.int16, device=dev)
    _build.launch("probe_bitcast", _SIGNATURE, dev, VARIANTS.index(variant), x.data_ptr(),
                  out.data_ptr(), out2.data_ptr() if out2 is not None else None, rows, lanes,
                  off_t.data_ptr(), off_t.shape[0] if variant == "F" else 0, WINDOW_ROWS)
    return (out, out2.view(torch.bfloat16)) if variant == "D" else out


def probe_bitcast_plain(variant: str, x: torch.Tensor, offsets: torch.Tensor = None):
    """The probe in plain PyTorch: ``view`` reinterpretations and integer
    arithmetic on u16 lanes widened to int32 (same outputs as
    ``probe_bitcast``)."""
    if variant == "F" and offsets is None:
        offsets = window_offsets(WINDOW_OFFSETS, x.device)
    _check(variant, x, offsets)
    if variant == "A":
        return x.view(torch.float32).clone()
    if variant == "B":
        return _f32_from_halves(_u16(x[:, 1::2]), _u16(x[:, 0::2]))
    if variant in "CD":
        half = x.shape[1] // 2
        out = _f32_from_halves(_u16(x[:, half:]), _u16(x[:, :half]))
        if variant == "C":
            return out
        return out, x[:, half:].contiguous().view(torch.bfloat16)
    if variant == "E":
        u = x.view(torch.int32)
        return torch.cat([_to_i16(u & 0xFFFF), _to_i16((u >> 16) & 0xFFFF)], dim=1)
    start = offsets.long().clamp(0, x.shape[0] - WINDOW_ROWS)
    return x[start[:, None] + torch.arange(WINDOW_ROWS, device=x.device)]


def ground_truth(seed: int = 0, rows: int = S, lanes: int = L) -> Dict[str, np.ndarray]:
    """The JAX probe's inputs and expected bits (numpy): f32 values of
    random magnitudes, their u16 halves as interleaved pairs and as
    halves, and F's source rows."""
    rng = np.random.default_rng(seed)
    f32 = (rng.normal(size=(rows, lanes)).astype(np.float32)
           * np.exp2(rng.integers(-20, 20, size=(rows, lanes))).astype(np.float32))
    u32 = f32.view(np.uint32)
    lo16 = (u32 & 0xFFFF).astype(np.uint16)
    hi16 = (u32 >> 16).astype(np.uint16)
    pairs = np.empty((rows, 2 * lanes), np.uint16)
    pairs[:, 0::2], pairs[:, 1::2] = lo16, hi16
    n, w = WINDOW_SRC
    src = np.arange(n * w, dtype=np.uint32).astype(np.uint16).reshape(n, w)
    return {"f32": f32, "u32": u32, "lo16": lo16, "hi16": hi16, "pairs": pairs,
            "halves": np.concatenate([lo16, hi16], axis=1), "src": src}


def variant_input(variant: str, gt: Dict[str, np.ndarray], device) -> torch.Tensor:
    """Variant ``variant``'s input tensor from ``ground_truth`` arrays."""
    arr = {"A": gt["pairs"], "B": gt["pairs"], "C": gt["halves"], "D": gt["halves"],
           "E": gt["f32"], "F": gt["src"]}[variant]
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def exact(variant: str, got, gt: Dict[str, np.ndarray]) -> bool:
    """Whether ``got`` carries exactly the ground truth's bits."""
    def bits(t, dtype):
        return t.detach().cpu().contiguous().view(dtype).numpy()

    if variant in "ABC":
        return np.array_equal(bits(got, torch.int32).view(np.uint32), gt["u32"])
    if variant == "D":
        return (np.array_equal(bits(got[0], torch.int32).view(np.uint32), gt["u32"])
                and np.array_equal(bits(got[1], torch.int16).view(np.uint16), gt["hi16"]))
    if variant == "E":
        return np.array_equal(bits(got, torch.int16).view(np.uint16), gt["halves"])
    want = np.stack([gt["src"][o:o + WINDOW_ROWS] for o in WINDOW_OFFSETS])
    return np.array_equal(bits(got, torch.int16).view(np.uint16), want)


def same_bits(a, b) -> bool:
    """Bit equality of two outputs (tuples for D)."""
    if isinstance(a, tuple):
        return all(same_bits(x, y) for x, y in zip(a, b))
    return torch.equal(a.contiguous().view(torch.int16), b.contiguous().view(torch.int16))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the f32 values of two outputs; the 16-bit
    outputs (D's colours, E, F: bf16 NaN patterns among them) count a bit
    difference as 1, none as 0."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.element_size() == 2:
        return float(not same_bits(a, b))
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def table_case(variant: str, rows: int, device, seed: int = 1):
    """Variant ``variant``'s input and window offsets at a table of ``rows``
    rows x ``TABLE_LANES`` f32 lanes (F: a (rows, 2 * TABLE_LANES) u16
    source, one 32-row window per 32 rows at a random offset)."""
    gt = ground_truth(seed, rows, TABLE_LANES)
    x = variant_input(variant, gt, device) if variant != "F" else torch.from_numpy(
        gt["halves"].view(np.int16)).to(device)
    offsets = None
    if variant == "F":
        rng = np.random.default_rng(seed)
        offsets = window_offsets(rng.integers(0, rows - WINDOW_ROWS + 1,
                                              size=rows // WINDOW_ROWS), device)
    return x, offsets


def table_bytes(variant: str, x: torch.Tensor, offsets) -> int:
    """Bytes the variant must move at ``x``: its input read once and its
    output written once (F: the windows, read and written, and the offsets)."""
    if variant == "F":
        return 2 * offsets.shape[0] * WINDOW_ROWS * x.shape[1] * 2 + offsets.shape[0] * 4
    extra = x.shape[0] * (x.shape[1] // 2) * 2 if variant == "D" else 0
    return 2 * x.numel() * x.element_size() + extra


def run(device="cuda", rows: int = 760_000, reps: int = 20) -> Dict[str, dict]:
    """Every variant: exact against the ground truth at (8, 128), equal to
    the plain version, and (on a CUDA device) timed at the table size.
    Prints one line per variant and returns the results by variant."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    gt = ground_truth()
    results = {}
    for v in VARIANTS:
        x = variant_input(v, gt, dev)
        got = probe_bitcast(v, x)
        ref = probe_bitcast_plain(v, x)
        res = {"exact": exact(v, got, gt), "equal_plain": same_bits(got, ref),
               "max_abs_err": max_abs_err(got, ref)}
        line = (f"{NAMES[v]:24s}: exact={res['exact']} equal to plain={res['equal_plain']}")
        if dev.type == "cuda":
            xt, offs = table_case(v, rows, dev)
            got_t, ref_t = probe_bitcast(v, xt, offs), probe_bitcast_plain(v, xt, offs)
            res["table_equal_plain"] = same_bits(got_t, ref_t)
            res["max_abs_err"] = max(res["max_abs_err"], max_abs_err(got_t, ref_t))
            res["ms"] = timed_ms(lambda: probe_bitcast(v, xt, offs), reps, True)
            res["plain_ms"] = timed_ms(lambda: probe_bitcast_plain(v, xt, offs), reps, True)
            res["bytes"] = table_bytes(v, xt, offs)
            res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
            if v == "A":
                res["library_ms"] = timed_ms(lambda: xt.view(torch.float32).clone(), reps, True)
            line += (f"; at {rows} rows x {TABLE_LANES} lanes: equal to plain="
                     f"{res['table_equal_plain']}, {res['ms']:.4f} ms (plain "
                     f"{res['plain_ms']:.4f} ms), bound {res['bound_ms']:.4f} ms by bytes "
                     f"({res['bytes']} B)")
        results[v] = res
        print(line, flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=760_000)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.device, args.rows, args.reps)


if __name__ == "__main__":
    main()
