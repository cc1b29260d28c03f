"""Cross-framework oracle: torch (CPU) reimplementation of the full render.

SURVEY.md section 4 item 1 asks for a CPU-torch oracle mirroring the
reference's gsplat semantics (rasterize.py:26-62) as an *independent* check —
same math, different framework, different autodiff. Images and parameter
gradients must agree with the JAX pipeline (dense oracle AND Pallas path) to
float32 tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysplat_tpu.data.synthetic import orbit_cameras, random_gaussian_cloud
from tinysplat_tpu.models.gaussians import GaussianParams
from tinysplat_tpu.render import render

from tests._torch_threads import one_torch_thread  # noqa: F401

H = W = 64
N = 80


def _torch_render(means, log_scales, quats, colors_dc, opac_logits,
                  viewmat, projmat, fx, fy, background):
    """Independent torch implementation of project + SH0 + composite."""
    means = means.double()
    scales = log_scales.double().exp()
    quats = quats.double()
    q = quats / quats.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    M = R * scales[:, None, :]
    cov3d = M @ M.transpose(1, 2)

    Wr = viewmat[:3, :3].double()
    t = viewmat[:3, 3].double()
    cam = means @ Wr.T + t
    tz = cam[:, 2]
    depths = tz
    tan_fovx = 0.5 * W / fx
    tan_fovy = 0.5 * H / fy
    txz = (cam[:, 0] / tz).clamp(-1.3 * tan_fovx, 1.3 * tan_fovx) * tz
    tyz = (cam[:, 1] / tz).clamp(-1.3 * tan_fovy, 1.3 * tan_fovy) * tz
    rz = 1.0 / tz
    J = torch.zeros(len(means), 2, 3, dtype=torch.float64)
    J[:, 0, 0] = fx * rz
    J[:, 0, 2] = -fx * txz * rz * rz
    J[:, 1, 1] = fy * rz
    J[:, 1, 2] = -fy * tyz * rz * rz
    T = J @ Wr
    cov2d = T @ cov3d @ T.transpose(1, 2) + 0.3 * torch.eye(2, dtype=torch.float64)

    a, b, c = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]
    det = a * c - b * b
    conic = torch.stack([c / det, -b / det, a / det], dim=-1)

    full = (projmat.double() @ viewmat.double())
    hom = torch.cat([means, torch.ones(len(means), 1, dtype=torch.float64)], 1) @ full.T
    ndc = hom[:, :2] / hom[:, 3:4]
    px_x = 0.5 * W * ndc[:, 0] + W / 2 - 0.5
    px_y = 0.5 * H * ndc[:, 1] + H / 2 - 0.5

    rgb = (colors_dc.double() * 0.28209479177387814 + 0.5).clamp(min=0.0)
    opac = torch.sigmoid(opac_logits.double().reshape(-1))
    valid = depths > 0.01

    order = torch.argsort(torch.where(valid, depths, torch.inf), stable=True)
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64), indexing="ij")
    dx = gx.reshape(-1, 1) - px_x[order][None]
    dy = gy.reshape(-1, 1) - px_y[order][None]
    ca, cb, cc = conic[order].unbind(-1)
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha = torch.minimum(torch.tensor(0.999, dtype=torch.float64),
                          opac[order] * torch.exp(-sigma))
    keep = (sigma >= 0) & (alpha >= 1.0 / 255.0) & valid[order][None]
    alpha = torch.where(keep, alpha, torch.zeros(()).double())
    t_incl = torch.cumprod(1 - alpha, dim=1)
    t_excl = torch.cat([torch.ones(H * W, 1, dtype=torch.float64), t_incl[:, :-1]], 1)
    live = t_incl > 1e-4
    wgt = torch.where(live, alpha * t_excl, torch.zeros(()).double())
    out = wgt @ rgb[order]
    t_final = torch.where(live, t_incl, torch.ones(()).double()).min(dim=1).values
    img = out + t_final[:, None] * background.double()[None]
    return img.reshape(H, W, 3).clamp(max=1.0)


def _setup():
    means, log_scales, quats, colors, opac = random_gaussian_cloud(
        N, seed=11, scale_range=(0.02, 0.1))
    cam = orbit_cameras(3, width=W, height=H)[1]
    return means, log_scales, quats, colors, opac, cam


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_render_matches_torch_oracle(backend):
    means, log_scales, quats, colors, opac, cam = _setup()
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)

    timg = _torch_render(
        torch.from_numpy(means), torch.from_numpy(log_scales),
        torch.from_numpy(quats), torch.from_numpy(colors / 0.28209479177387814 - 0.5 / 0.28209479177387814),
        torch.from_numpy(opac),
        torch.from_numpy(np.asarray(cam.view_matrix)),
        torch.from_numpy(np.asarray(cam.proj_matrix)),
        cam.f_x, cam.f_y, torch.from_numpy(bg),
    ).numpy()

    dc = colors / 0.28209479177387814 - 0.5 / 0.28209479177387814
    params = GaussianParams(
        means=jnp.asarray(means),
        colors_dc=jnp.asarray(dc.astype(np.float32)),
        colors_rest=jnp.zeros((N, 0, 3)),
        scales=jnp.asarray(log_scales),
        quats=jnp.asarray(quats),
        opacities=jnp.asarray(opac),
    )
    rgb, _ = render(params, jnp.ones(N, bool), cam.params(), H, W,
                    jnp.int32(0), jnp.asarray(bg), rasterizer=backend)
    np.testing.assert_allclose(np.asarray(rgb), timg, atol=2e-4)


@pytest.mark.slow  # heavy; fast gate keeps a cheaper representative
def test_gradients_match_torch_oracle():
    means, log_scales, quats, colors, opac, cam = _setup()
    bg = np.asarray([0.0, 0.0, 0.0], np.float32)
    dc = (colors / 0.28209479177387814 - 0.5 / 0.28209479177387814).astype(np.float32)

    # torch grads of sum(img^2) w.r.t. means and opacities.
    tm = torch.from_numpy(means).requires_grad_(True)
    to = torch.from_numpy(opac).requires_grad_(True)
    timg = _torch_render(
        tm, torch.from_numpy(log_scales), torch.from_numpy(quats),
        torch.from_numpy(dc), to,
        torch.from_numpy(np.asarray(cam.view_matrix)),
        torch.from_numpy(np.asarray(cam.proj_matrix)),
        cam.f_x, cam.f_y, torch.from_numpy(bg),
    )
    (timg ** 2).sum().backward()

    params = GaussianParams(
        means=jnp.asarray(means),
        colors_dc=jnp.asarray(dc),
        colors_rest=jnp.zeros((N, 0, 3)),
        scales=jnp.asarray(log_scales),
        quats=jnp.asarray(quats),
        opacities=jnp.asarray(opac),
    )

    def loss(p):
        rgb, _ = render(p, jnp.ones(N, bool), cam.params(), H, W,
                        jnp.int32(0), jnp.asarray(bg), rasterizer="pallas")
        return jnp.sum(rgb ** 2)

    g = jax.grad(loss)(params)
    # Normalized comparison: grads span orders of magnitude across splats.
    gm, tgm = np.asarray(g.means), tm.grad.numpy()
    scale = np.abs(tgm).max()
    np.testing.assert_allclose(gm / scale, tgm / scale, atol=5e-4)
    go, tgo = np.asarray(g.opacities), to.grad.numpy()
    oscale = max(np.abs(tgo).max(), 1e-12)
    np.testing.assert_allclose(go / oscale, tgo / oscale, atol=5e-4)
