"""What each layer of a step or a frame has to do, counted from the cell's
inputs by the benchmark's own plain code, and the roofline arithmetic.

The counts depend on the scene, the camera and the image size only, never
on how a kernel is written; ``reference.render.count_work`` gives the
compositing pairs of a frame (``work`` below: its dict). Bytes count each
input read once and each output written once; FLOP count float32
operations (an exp or a division as one).

Compositing forward (K1), per pixel walking its tile's list front to back:
    FLOP  = 16 a pair inside the entry's box up to the pixel's stop
            (``k1_box``): dx, dy (2), sigma (9), exp (1), opacity x exp (1),
            the clamp (1), the sigma and alpha tests (2).
    bytes = 40 a valid splat (centre 8, conic 12, opacity 4, colour and
            depth 16) + 4 an entry (its splat) + 24 a pixel written (four
            channels, final transmittance, index of the last contributor).
Compositing backward (K2):
    FLOP  = 16 a pair inside the box up to the pixel's last contributor
            (``k2_box``: alpha again) + 60 a contributing pair (``kept``):
            1 / (1 - alpha) and the transmittance (3), per channel the
            colour gradient, the accumulated colour behind and its share of
            dL/dalpha (4 x 7), the background's share (3), dL/dsigma and
            dL/dopacity (4), the conic's three gradients (11), the centre's
            two (10), accumulation of the opacity's (1).
    bytes = 40 a valid splat in + 4 an entry + 24 a pixel of the forward's
            output and 20 of its cotangent (four channels, transmittance) in
            + 40 a valid splat's gradient out.
Binning (B1-B4): no arithmetic to speak of;
    bytes = 33 a splat in (centre 8, depth 4, radius 4, conic 12, opacity 4,
            valid 1) + 4 an entry out (its splat, in tile and depth order)
            + 8 a tile out (start, count).
Splat inputs forward (S1), per splat at K SH bases:
    bytes = 4 (3 + 3 + 4 + 3 K + 1) + 1 in (mean, log-scale, quaternion,
            SH coefficients, opacity logit, alive) + 45 out (centre 8, depth
            4, radius 4, conic 12, rgb 12, opacity 4, valid 1);
    FLOP  = 500 (projection ~170, covariance and conic ~150, SH to degree 3
            ~150, the rest ~30; counted from the kernel's plain version and
            rounded up: the bound it gives stays under the bytes bound).
Splat inputs backward (S2): bytes = the inputs twice (read, and their
    gradients written) + 40 of cotangents (centre, depth, conic, rgb,
    opacity); FLOP = 1500.
SSIM (the loss), at H x W x 3: five maps blurred by an 11-tap separable
    window, valid positions: 2 x 11 FLOP an output of each pass, forward and
    transposed in the backward; ~40 FLOP a position for the rest.
Adam: 12 FLOP a parameter (two moments, bias corrections, root, update).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
FLOP_S = PEAKS["fp32_flop_per_s"]
BYTES_S = PEAKS["hbm_bytes_per_s"]

K1_FLOP_PER_PAIR = 16
K2_FLOP_PER_KEPT = 60
S1_FLOP, S2_FLOP = 500, 1500
ADAM_FLOP = 12
SSIM_TAPS, SSIM_MAPS, SSIM_REST_FLOP = 11, 5, 40


def bound_s(flop: float, nbytes: float) -> float:
    """The least time the device could take: FLOP or bytes at the peak."""
    return max(flop / FLOP_S, nbytes / BYTES_S)


def splat_in_bytes(k_bases: int) -> int:
    return 4 * (3 + 3 + 4 + 3 * k_bases + 1)


def k1(work: dict):
    return (K1_FLOP_PER_PAIR * work["k1_box"],
            40 * work["valid"] + 4 * work["entries"] + 24 * work["pixels"])


def k2(work: dict):
    return (K1_FLOP_PER_PAIR * work["k2_box"] + K2_FLOP_PER_KEPT * work["kept"],
            80 * work["valid"] + 4 * work["entries"] + 44 * work["pixels"])


def binning(work: dict):
    return 0, 33 * work["splats"] + 4 * work["entries"] + 8 * work["tiles"]


def s1(work: dict, k_bases: int):
    return S1_FLOP * work["splats"], work["splats"] * (splat_in_bytes(k_bases) + 1 + 45)


def s2(work: dict, k_bases: int):
    return S2_FLOP * work["splats"], work["splats"] * (2 * splat_in_bytes(k_bases) + 40)


def ssim_flop(height: int, width: int) -> float:
    """Forward and backward of the loss's SSIM at one (H, W, 3) image."""
    h2, w2 = height - SSIM_TAPS + 1, width - SSIM_TAPS + 1
    blur = 2 * SSIM_TAPS * SSIM_MAPS * 3 * (h2 * width + h2 * w2)
    return 2 * blur + 2 * SSIM_REST_FLOP * 3 * h2 * w2


def step_flop(work: dict, k_bases: int, height: int, width: int, params: int) -> float:
    """A training step's FLOP: K1, K2, S1, S2, the loss (SSIM and L1) and Adam."""
    return (k1(work)[0] + k2(work)[0] + s1(work, k_bases)[0] + s2(work, k_bases)[0]
            + ssim_flop(height, width) + 5 * 3 * height * width + ADAM_FLOP * params)


def frame_flop(work: dict, k_bases: int) -> float:
    return k1(work)[0] + s1(work, k_bases)[0]


def roofline_pct(ctx, kernels, cost) -> float | None:
    """100 x (the summed bound of the traced calls) / (the kernels' device
    time), or None when the trace holds none of ``kernels``."""
    secs, launches = ctx.trace.kernel_s(kernels)
    if launches == 0 or secs <= 0 or not ctx.work:
        return None
    return 100.0 * sum(bound_s(*cost(w)) for w in ctx.work) / secs
