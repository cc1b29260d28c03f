"""Checkpoint export CLI of the port: PLY / SPLAT, with the flags of the JAX
package's ``scripts/export.py``.

    python -m tinysplat_torch.export_cli --filetype PLY checkpoint.npz out.ply
    python -m tinysplat_torch.export_cli --filetype SPLAT model.ply out.splat

The input is a ``.npz`` checkpoint of either package (its ``model/*``
arrays) or a 3DGS PLY. ``--device`` (default ``cuda``, as in ``train_cli``)
is where the state is loaded. The files are byte-identical to the JAX
exporter's for the same state.

Not ported yet (raises NotImplementedError): ``--filetype OBJ``, whose mesh
extraction (``mesh.py``, ``poisson.py``) is ROADMAP Queue 1 item 15; its
flags are parsed as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from .train import _not_ported


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


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = arg_parser().parse_args(argv)
    if args.filetype == "OBJ":
        raise _not_ported("--filetype OBJ (mesh extraction)", "mesh.py and poisson.py",
                          "item 15")

    from .io.checkpoint import load_model
    from .io.export import export_ply, export_splat, import_ply

    if args.input_file.endswith(".ply"):
        state = import_ply(args.input_file, device=args.device)
    else:
        state = load_model(args.input_file, device=args.device)
    if args.filetype == "PLY":
        export_ply(state, args.output_file)
    else:
        export_splat(state, args.output_file)
    logging.info("wrote %s", args.output_file)


if __name__ == "__main__":
    main()
