"""Multi-device training on ``torch.distributed``: the mesh, the sharded
step and the mesh trainer.

Torch port of ``tinysplat_tpu.parallel``. Splat parameters and their Adam
moments are FSDP-sharded over every rank of a ('data', 'tile') mesh, image
pixel rows over the 'tile' axis (interleaved bands of tile rows, ``tile_size`` px
each, by default) and cameras over the 'data' axis. One rank drives one device; the
ranks meet only in the collectives of ``collectives`` (NCCL between cards,
gloo on the CPU and for ranks that share a card). ``local.run`` starts N
local ranks of one program.
"""
from .sharding import host_to_global, make_mesh, shard_state, state_shardings
from .train_step import make_sharded_render, make_sharded_train_step
from .trainer import MeshTrainer, init_distributed, rank_device

__all__ = [
    "MeshTrainer",
    "host_to_global",
    "init_distributed",
    "make_mesh",
    "make_sharded_render",
    "make_sharded_train_step",
    "rank_device",
    "shard_state",
    "state_shardings",
]
