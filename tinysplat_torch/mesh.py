"""Mesh extraction from a trained splat model.

Torch port of ``tinysplat_tpu.mesh``. Two paths:

- ``marching_cubes``: the iso-surface of the SuGaR mixture density
  (``regularizers/density.py``) on a regular grid over the live splats'
  bounds (padded 10%), evaluated in chunks on the state's device (the KNN
  and the density); the iso-surfacer is the marching-*tetrahedra* kernel
  below (each cell split into 6 tetrahedra, case tables derived in code),
  a numpy copy of the JAX package's, so the same field gives the same
  mesh bit for bit.
- ``poisson``: density level-crossing points along camera rays (render the
  depth through ``scene.render``, i.e. the compositing kernel K1 on the
  card; backproject it; march +-3 sigma along each view ray through the
  mixture density) and the spectral screened-Poisson reconstruction of
  ``poisson.py`` on the device.

``extract_mesh(..., timings=dict)`` writes each stage's seconds there, the
device synchronized at the end of each stage.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .models.gaussians import GaussianState
from .utils.device import timed

# The 6-tetrahedra decomposition of a cube (indices into the cube's 8
# corners, ordered so all tets share the main diagonal 0-7 => conforming
# faces between neighboring cells).
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int32,
)
# Cube corner offsets in (x, y, z).
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    np.int32,
)
# For each of the 16 sign patterns of a tet's 4 corners, the edges
# (pairs of local corner ids) whose crossings form the triangle(s).
# Derived once at import time — no hand-maintained tables.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_cases():
    """case id (bitmask of corners above iso) -> list of edge-index triples."""
    cases = []
    for case in range(16):
        above = [bool(case & (1 << i)) for i in range(4)]
        crossed = [
            ei for ei, (a, b) in enumerate(_TET_EDGES) if above[a] != above[b]
        ]
        n_above = sum(above)
        if n_above in (0, 4):
            cases.append([])
        elif n_above in (1, 3):
            # One corner separated: single triangle over its 3 edges. Order
            # them consistently around the lone corner for outward normals.
            lone = above.index(True) if n_above == 1 else above.index(False)
            tri = [ei for ei in crossed if lone in _TET_EDGES[ei]]
            assert len(tri) == 3
            cases.append([tuple(tri)])
        else:
            # Two corners separated: quad over the 4 crossed edges -> 2 tris.
            assert len(crossed) == 4
            # Sort the quad so consecutive edges share a tet face.
            e0 = crossed[0]
            rest = crossed[1:]
            a0, b0 = _TET_EDGES[e0]
            # neighbor shares exactly one endpoint with e0
            nxt = [e for e in rest if len(set(_TET_EDGES[e]) & {a0, b0}) == 1]
            quad = [e0, nxt[0]]
            rest.remove(nxt[0])
            last = _TET_EDGES[nxt[0]]
            nxt2 = [e for e in rest if len(set(_TET_EDGES[e]) & set(last)) == 1]
            quad.append(nxt2[0])
            rest.remove(nxt2[0])
            quad.append(rest[0])
            cases.append([(quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])])
    return cases


_CASES = _tet_cases()

# Static (16, 2, 3) table: TRI_TABLE[case, t] = the t-th triangle's three
# edge indices (into _TET_EDGES), or -1 rows for absent triangles — the
# vectorized kernel gathers through it per tet.
_TRI_TABLE = np.full((16, 2, 3), -1, np.int32)
for _case, _tris in enumerate(_CASES):
    for _t, _tri in enumerate(_tris):
        _TRI_TABLE[_case, _t] = _tri
_EDGE_A = np.asarray([e[0] for e in _TET_EDGES], np.int32)
_EDGE_B = np.asarray([e[1] for e in _TET_EDGES], np.int32)


def marching_tetrahedra(
    field: np.ndarray,
    iso: float,
    origin: np.ndarray,
    spacing: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a (Nx, Ny, Nz) scalar field.

    Returns (vertices (V, 3) world coords, faces (F, 3)). Vertices on
    shared edges are merged (watertight where the field is well-behaved).

    Fully vectorized over the ACTIVE (sign-changing) cells: the per-cell
    Python loop of the reference implementation below costs minutes and the
    all-cells (C, 8, 3) int64 corner materialization ~3 GB at a 256 grid;
    here activity is found with 8 shifted boolean views, per-tet case ids
    and triangle edges come from static tables, and shared-edge vertex
    merging is one np.unique over packed (lo * nvox + hi) edge keys.
    Equivalence with the reference oracle is tested
    (tests/test_torch_port_mesh.py holds this copy to the JAX package's).
    """
    nx, ny, nz = field.shape
    b = field > iso
    # Cell activity from shifted views — no (C, 8) materialization.
    c_any = np.zeros((nx - 1, ny - 1, nz - 1), bool)
    c_all = np.ones((nx - 1, ny - 1, nz - 1), bool)
    for dx, dy, dz in _CORNERS:
        v = b[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        c_any |= v
        c_all &= v
    cells = np.argwhere(c_any & ~c_all)  # (A, 3)
    if len(cells) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    strides = np.asarray([ny * nz, nz, 1], np.int64)
    corner_off = (_CORNERS.astype(np.int64) @ strides)  # (8,)
    g0 = cells.astype(np.int64) @ strides  # (A,)
    cell_g = g0[:, None] + corner_off[None, :]  # (A, 8) flat grid ids
    flat = field.ravel()
    vals = flat[cell_g]  # (A, 8)
    above = vals > iso

    keys_acc, va_acc, vb_acc, ga_acc, gb_acc = [], [], [], [], []
    nvox = np.int64(nx) * ny * nz
    for tet in _TETS:  # 6 static iterations; everything inside is (A,)-wide
        case = (
            above[:, tet[0]].astype(np.int32)
            | (above[:, tet[1]].astype(np.int32) << 1)
            | (above[:, tet[2]].astype(np.int32) << 2)
            | (above[:, tet[3]].astype(np.int32) << 3)
        )
        for t in range(2):
            tri = _TRI_TABLE[case, t]  # (A, 3) edge indices or -1
            valid = tri[:, 0] >= 0
            if not valid.any():
                continue
            tri = tri[valid]  # (T, 3)
            cg = cell_g[valid]
            cv = vals[valid]
            la = tet[_EDGE_A[tri]]  # (T, 3) local cube corners
            lb = tet[_EDGE_B[tri]]
            ga = np.take_along_axis(cg, la, axis=1)  # (T, 3) global ids
            gb = np.take_along_axis(cg, lb, axis=1)
            va = np.take_along_axis(cv, la, axis=1)
            vb = np.take_along_axis(cv, lb, axis=1)
            lo = np.minimum(ga, gb)
            hi = np.maximum(ga, gb)
            keys_acc.append(lo * nvox + hi)
            # Canonical endpoint order (lo first) so every occurrence of an
            # edge interpolates identically regardless of traversal side.
            swap = ga > gb
            va_c = np.where(swap, vb, va)
            vb_c = np.where(swap, va, vb)
            va_acc.append(va_c)
            vb_acc.append(vb_c)
            ga_acc.append(lo)
            gb_acc.append(hi)

    keys = np.concatenate([k.ravel() for k in keys_acc])
    uniq, inv = np.unique(keys, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int64)
    first = np.full(len(uniq), -1, np.int64)
    # First occurrence per unique key (stable: reverse fill).
    order = np.arange(len(keys))[::-1]
    first[inv[::-1]] = order
    va_all = np.concatenate([v.ravel() for v in va_acc])[first]
    vb_all = np.concatenate([v.ravel() for v in vb_acc])[first]
    ga_all = np.concatenate([g.ravel() for g in ga_acc])[first]
    gb_all = np.concatenate([g.ravel() for g in gb_acc])[first]
    t_interp = (iso - va_all) / (vb_all - va_all)
    pa = np.stack(np.unravel_index(ga_all, field.shape), axis=-1).astype(np.float64)
    pb = np.stack(np.unravel_index(gb_all, field.shape), axis=-1).astype(np.float64)
    verts_grid = pa + t_interp[:, None] * (pb - pa)

    # Consistent outward winding (see the reference implementation).
    grad = np.stack(np.gradient(field), axis=-1)
    centroids = verts_grid[faces].mean(axis=1)
    ci = np.clip(np.round(centroids).astype(np.int64), 0,
                 np.asarray(field.shape) - 1)
    g = grad[ci[:, 0], ci[:, 1], ci[:, 2]]
    v0, v1, v2 = (verts_grid[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    flip = np.sum(fn * g, axis=-1) > 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    verts = verts_grid * spacing + np.asarray(origin)[None]
    return verts, faces


def _marching_tetrahedra_reference(
    field: np.ndarray,
    iso: float,
    origin: np.ndarray,
    spacing: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Readable per-cell Python implementation — kept as the tested ORACLE
    for the vectorized `marching_tetrahedra` (same topology, same vertex
    positions up to merge order). Do not call on large grids."""
    nx, ny, nz = field.shape
    cells = np.stack(
        np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)

    # Corner values for all cells: (C, 8)
    corner_idx = cells[:, None, :] + _CORNERS[None, :, :]
    vals = field[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    above = vals > iso

    verts_acc = []
    faces_acc = []
    edge_cache = {}

    def edge_vertex(gi_a, gi_b, va, vb):
        key = (gi_a, gi_b) if gi_a < gi_b else (gi_b, gi_a)
        cached = edge_cache.get(key)
        if cached is not None:
            return cached
        t = (iso - va) / (vb - va)
        pa = np.asarray(np.unravel_index(gi_a, field.shape), np.float64)
        pb = np.asarray(np.unravel_index(gi_b, field.shape), np.float64)
        p = pa + t * (pb - pa)
        idx = len(verts_acc)
        verts_acc.append(p)
        edge_cache[key] = idx
        return idx

    # Only cells whose corner signs differ contribute.
    active = np.where(above.any(axis=1) & ~above.all(axis=1))[0]
    strides = np.array([ny * nz, nz, 1])
    for ci in active:
        cell_g = corner_idx[ci] @ strides  # (8,) flat grid ids
        cell_v = vals[ci]
        cell_a = above[ci]
        for tet in _TETS:
            case = sum(1 << i for i in range(4) if cell_a[tet[i]])
            for tri in _CASES[case]:
                ids = []
                for ei in tri:
                    a, b = _TET_EDGES[ei]
                    ids.append(
                        edge_vertex(
                            int(cell_g[tet[a]]), int(cell_g[tet[b]]),
                            float(cell_v[tet[a]]), float(cell_v[tet[b]]),
                        )
                    )
                faces_acc.append(ids)

    if not verts_acc:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts_grid = np.asarray(verts_acc)  # grid coords
    faces = np.asarray(faces_acc, np.int64)

    # Consistent outward winding: orient each face against the field
    # gradient (the surface normal points toward decreasing field, i.e. out
    # of the >iso region). The 6-tet decomposition mixes chirality, so per-
    # face orientation by gradient is the robust fix.
    grad = np.stack(np.gradient(field), axis=-1)  # (Nx, Ny, Nz, 3)
    centroids = verts_grid[faces].mean(axis=1)
    ci = np.clip(np.round(centroids).astype(np.int64), 0,
                 np.asarray(field.shape) - 1)
    g = grad[ci[:, 0], ci[:, 1], ci[:, 2]]
    v0, v1, v2 = (verts_grid[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    flip = np.sum(fn * g, axis=-1) > 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    verts = verts_grid * spacing + np.asarray(origin)[None]
    return verts, faces


@torch.no_grad()
def _density_grid(state: GaussianState, resolution: int, padding: float = 0.1,
                  k: int = 16, chunk: int = 65536) -> Tuple[np.ndarray, np.ndarray, float]:
    """The SuGaR mixture density on a (resolution,)*3 grid over the live
    means' bounds padded by ``padding``, evaluated on the state's device in
    chunks of ``chunk`` grid points. Returns (field, origin, spacing)."""
    from .regularizers.density import density_at_points, knn_indices

    alive = state.alive.cpu().numpy()
    means = state.params.means.detach().cpu().numpy()[alive]
    lo = means.min(axis=0)
    hi = means.max(axis=0)
    span = float((hi - lo).max()) * (1 + padding)
    center = (hi + lo) / 2
    origin = center - span / 2
    spacing = span / (resolution - 1)

    axes = [np.linspace(origin[i], origin[i] + span, resolution) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)

    dev = state.alive.device
    out = []
    for i in range(0, grid.shape[0], chunk):
        pts = torch.as_tensor(grid[i:i + chunk], dtype=torch.float32, device=dev)
        idx = knn_indices(pts, state.params.means, state.alive, k=k)
        out.append(density_at_points(pts, idx, state.params))
    field = torch.cat(out).cpu().numpy()
    return field.reshape(resolution, resolution, resolution), origin, spacing


@torch.no_grad()
def extract_level_surface_points(
    scene,
    state: GaussianState,
    num_total_points: int = 200_000,
    surface_level: float = 0.3,
    num_steps: int = 21,
    return_view_origins: bool = False,
):
    """Density level-crossing points along camera rays: backproject the
    rendered depth of ``num_total_points / len(cameras)`` random pixels per
    camera (numpy draws, seed 0), march +-3 sigma (the nearest splat's
    scale norm) along the view ray in ``num_steps`` samples, and linearly
    interpolate the first crossing of ``surface_level``. Returns (P, 3)
    numpy points (and each one's camera position with
    ``return_view_origins``)."""
    from .regularizers.density import density_at_points, knn_indices

    cams = scene.cameras
    per_cam = max(num_total_points // max(len(cams), 1), 1)
    rng = np.random.default_rng(0)
    params, alive = state.params, state.alive
    dev = alive.device
    steps = torch.linspace(-3, 3, num_steps, device=dev)[None, :]
    out, out_cams = [], []
    for cam in cams:
        _, extras = scene.render(cam)
        depth = extras["depth"].reshape(-1)
        h, w = cam.height, cam.width
        idxs = rng.permutation(h * w)[:per_cam]
        y, x = np.divmod(idxs, w)
        p_screen = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev),
                                torch.as_tensor(y, dtype=torch.float32, device=dev),
                                depth[torch.as_tensor(idxs, device=dev)]], dim=-1)
        p_world = cam.backproject_points(p_screen)
        # Pixels with no depth backproject to non-finite points, whose
        # density is NaN and never crosses the level: drop them first.
        p_world = p_world[torch.isfinite(p_world).all(dim=-1)]
        if p_world.shape[0] == 0:
            continue

        knn = knn_indices(p_world, params.means, alive, k=16)
        p_std = torch.linalg.norm(torch.exp(params.scales)[knn[:, 0]], dim=-1)
        t_range = steps * p_std[:, None]  # (P, S)
        p_dir = p_world - torch.as_tensor(cam.position, device=dev)[None]
        p_dir = p_dir / torch.clamp(torch.linalg.norm(p_dir, dim=-1, keepdim=True), min=1e-12)
        samples = (p_world[:, None, :] + t_range[..., None] * p_dir[:, None, :]).reshape(-1, 3)
        sknn = knn_indices(samples, params.means, alive, k=16)
        d = density_at_points(samples, sknn, params).reshape(-1, num_steps)

        above = d > surface_level
        first_above = torch.argmax(above.to(torch.int8), dim=1)
        ok = (d[:, 0] < surface_level) & above.any(dim=1) & (first_above > 0)
        rows = torch.nonzero(ok)[:, 0]
        if rows.numel() == 0:
            continue
        fa = first_above[rows]
        d0, d1 = d[rows, fa - 1], d[rows, fa]
        t0, t1 = t_range[rows, fa - 1], t_range[rows, fa]
        t_cross = (surface_level - d0) / torch.clamp(d1 - d0, min=1e-12) * (t1 - t0) + t0
        out.append((p_world[rows] + t_cross[:, None] * p_dir[rows]).cpu().numpy())
        out_cams.append(np.broadcast_to(cam.position[None], out[-1].shape))
    pts = np.concatenate(out) if out else np.zeros((0, 3), np.float32)
    if return_view_origins:
        vo = np.concatenate(out_cams) if out_cams else np.zeros((0, 3), np.float32)
        return pts, vo
    return pts


def extract_mesh(
    state: GaussianState,
    algorithm: str = "marching_cubes",
    resolution: int = 128,
    surface_level: float = 0.5,
    scene=None,
    poisson_depth: int = 9,
    timings: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Extract (vertices, faces, normals) from a trained model, on the
    state's device. ``timings``: a dict that receives each stage's seconds
    (``grid_knn_density``, ``marching_tetrahedra``; for poisson
    ``level_points`` and ``reconstruct``'s stages)."""
    if int(state.num_live()) == 0:
        # All dead: an empty mesh, not a zero-size reduction in the bounds.
        empty3 = np.zeros((0, 3), np.float32)
        return empty3, np.zeros((0, 3), np.int32), empty3
    dev = state.alive.device
    if algorithm == "marching_cubes":
        with timed(timings, "grid_knn_density", dev):
            field, origin, spacing = _density_grid(state, resolution)
        with timed(timings, "marching_tetrahedra", dev):
            verts, faces = marching_tetrahedra(field, surface_level, origin, spacing)
            normals = vertex_normals(verts, faces)
        return verts, faces, normals
    if algorithm == "poisson":
        if scene is None:
            raise ValueError("poisson extraction needs scene= (rendered depth)")
        with timed(timings, "level_points", dev):
            pts, view_origins = extract_level_surface_points(
                scene, state, return_view_origins=True)
        from .poisson import reconstruct

        # The octree depth maps to a uniform grid of 2^depth cells, capped
        # at 256 (finer than depth-9 octree leaves on these scenes).
        return reconstruct(pts, view_origins, resolution=min(2 ** poisson_depth, 256),
                           device=dev, timings=timings)
    raise ValueError(f"Unknown mesh extraction algorithm: {algorithm}")


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    if len(faces) == 0:
        return np.zeros_like(verts)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(verts)
    for i in range(3):
        np.add.at(out, faces[:, i], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-12)
