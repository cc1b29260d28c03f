"""Spherical-harmonics color evaluation (torch port of ``tinysplat_tpu.ops.sh``).

Real SH bases up to degree 4 (25 coefficients), the same basis order and
constants as gsplat and the JAX package, so checkpoints are interchangeable.
Bands above the active degree are masked to zero, so a state whose stored
degree is higher than its active one renders as the JAX package does.
"""
from __future__ import annotations

import torch

# Y_l^m normalization constants (same values as gsplat's sh.cu / sh.py).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    """(degree + 1)^2 — gsplat ``num_sh_bases`` semantics (degree <= 4)."""
    return (degree + 1) ** 2


def deg_from_sh(num_bases: int) -> int:
    """Inverse of :func:`num_sh_bases`; exact match only."""
    for deg in range(5):
        if num_sh_bases(deg) == num_bases:
            return deg
    raise ValueError(
        f"Unsupported number of SH bases: {num_bases} (must be one of "
        f"1, 4, 9, 16, 25)")


def sh_basis(dirs: torch.Tensor, num_bases: int) -> torch.Tensor:
    """(..., num_bases) real SH basis values for (..., 3) unit directions."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full(x.shape, SH_C0, dtype=dirs.dtype, device=dirs.device)]
    if num_bases > 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if num_bases > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if num_bases > 9:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if num_bases > 16:
        out += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def band_of_basis(num_bases: int, device="cpu") -> torch.Tensor:
    """(num_bases,) int32: SH band (degree) of each basis index."""
    bands = []
    for deg in range(5):
        bands += [deg] * (2 * deg + 1)
    return torch.tensor(bands[:num_bases], dtype=torch.int32, device=device)


def eval_sh(active_degree, dirs: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """SH colors: sum_k basis_k(dir) * coeffs[..., k, :], bases above
    ``active_degree`` (an int or a 0-d tensor) masked to zero.

    Args:
      dirs: (N, 3) unit view directions.
      coeffs: (N, K, 3) SH coefficients, K the *stored* number of bases.

    Returns:
      (N, 3) raw SH colors (the caller applies the +0.5 shift and clamp).
    """
    num_bases = coeffs.shape[-2]
    basis = sh_basis(dirs, num_bases)  # (N, K)
    mask = band_of_basis(num_bases, dirs.device) <= torch.as_tensor(
        active_degree, dtype=torch.int32, device=dirs.device)
    basis = torch.where(mask, basis, 0.0)
    return torch.einsum("...k,...kc->...c", basis, coeffs)
