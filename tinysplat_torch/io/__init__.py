from .checkpoint import (
    load_checkpoint,
    load_checkpoint_extras,
    load_checkpoint_sharded_extras,
    load_model,
    restore_checkpoint_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
)
from .export import export_mesh_obj, export_ply, export_splat, import_ply
from .ply import read_ply, write_ply

__all__ = [
    "export_mesh_obj",
    "export_ply",
    "export_splat",
    "import_ply",
    "load_checkpoint",
    "load_checkpoint_extras",
    "load_checkpoint_sharded_extras",
    "load_model",
    "read_ply",
    "restore_checkpoint_sharded",
    "save_checkpoint",
    "save_checkpoint_sharded",
    "write_ply",
]
