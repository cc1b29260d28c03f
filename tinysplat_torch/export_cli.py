"""Checkpoint export CLI of the port: PLY / SPLAT / OBJ mesh, with the flags
of the JAX package's ``scripts/export.py``.

    python -m tinysplat_torch.export_cli --filetype PLY checkpoint.npz out.ply
    python -m tinysplat_torch.export_cli --filetype SPLAT model.ply out.splat
    python -m tinysplat_torch.export_cli --filetype OBJ \
        --mesh-extraction-algorithm marching_cubes --resolution 128 ck.npz mesh.obj
    python -m tinysplat_torch.export_cli --filetype OBJ \
        --mesh-extraction-algorithm poisson --poisson-depth 8 ck.npz mesh.obj

The input is a ``.npz`` checkpoint of either package (its ``model/*``
arrays) or a 3DGS PLY. ``--device`` (default ``cuda``, as in ``train_cli``)
is where the state is loaded and where the mesh extraction runs. PLY and
.splat files are byte-identical to the JAX exporter's for the same state.

OBJ (``mesh.extract_mesh``): ``marching_cubes`` iso-surfaces the mixture
density on a ``--resolution``^3 grid; ``poisson`` needs rendered depth, and
a bare checkpoint carries no cameras, so it renders 16 orbit cameras at
256x256 around the live splats (radius 2.5x their extent) with the port's
default rasterizer (the compositing kernel on the card) and reconstructs on
a 2^``--poisson-depth`` grid (capped at 256). ``main`` returns the mesh's
vertex and face counts and each stage's seconds.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export a trained splat model")
    parser.add_argument("--filetype", type=str, default="PLY",
                        choices=["PLY", "SPLAT", "OBJ"])
    parser.add_argument("--mesh-extraction-algorithm", type=str,
                        default="marching_cubes",
                        choices=["marching_cubes", "poisson"])
    parser.add_argument("--resolution", type=int, default=256,
                        help="marching-cubes grid resolution")
    parser.add_argument("--poisson-depth", type=int, default=9,
                        help="poisson octree depth (grid = 2^depth, capped)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the state is loaded (cuda or cpu)")
    parser.add_argument("input_file", type=str, help=".npz checkpoint or .ply")
    parser.add_argument("output_file", type=str)
    return parser


def orbit_scene(state, views: int = 16, size: int = 256):
    """A ``Scene`` of ``views`` orbit cameras at size x size around the
    live splats (centred on their mean, radius 2.5x their extent), bound to
    a render of ``state`` over black with the default rasterizer."""
    import numpy as np
    import torch

    from .data.synthetic import orbit_cameras
    from .render import render
    from .scene import Scene

    means = state.params.means.detach()[state.alive].cpu().numpy()
    center = means.mean(axis=0)
    radius = max(2.5 * float(np.linalg.norm(means - center, axis=1).max()), 1e-2)
    scene = Scene(orbit_cameras(views, width=size, height=size, radius=radius,
                                target=tuple(center)))
    dev = state.alive.device

    def render_fn(camera, dims=None):
        w, h = dims if dims is not None else (camera.width, camera.height)
        with torch.no_grad():
            return render(state.params, state.alive, camera.params(dev), h, w,
                          state.active_sh_degree, torch.zeros(3, device=dev))

    scene.render_fn = render_fn
    return scene


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = arg_parser().parse_args(argv)
    from .io.checkpoint import load_model
    from .io.export import export_mesh_obj, export_ply, export_splat, import_ply

    if args.input_file.endswith(".ply"):
        state = import_ply(args.input_file, device=args.device)
    else:
        state = load_model(args.input_file, device=args.device)
    summary = None
    if args.filetype == "PLY":
        export_ply(state, args.output_file)
    elif args.filetype == "SPLAT":
        export_splat(state, args.output_file)
    else:
        from .mesh import extract_mesh

        scene = (orbit_scene(state) if args.mesh_extraction_algorithm == "poisson"
                 else None)
        timings: dict = {}
        verts, faces, normals = extract_mesh(
            state, algorithm=args.mesh_extraction_algorithm, resolution=args.resolution,
            scene=scene, poisson_depth=args.poisson_depth, timings=timings)
        export_mesh_obj(args.output_file, verts, faces, normals)
        summary = {"vertices": len(verts), "faces": len(faces), "seconds": timings}
        logging.info("mesh (%s): %d vertices, %d faces; seconds by stage %s",
                     args.mesh_extraction_algorithm, len(verts), len(faces), timings)
    logging.info("wrote %s", args.output_file)
    return summary


if __name__ == "__main__":
    main()
