"""The ('data', 'tile') mesh over the ranks of a process group, and the
placement of the splat state on it.

Torch port of ``tinysplat_tpu.parallel.sharding``. One rank drives one
device, so the mesh is the world of ranks: rank r = d * n_tile + t has mesh
coordinates (d, t).

  'data' — camera batch: each data group renders its own training views;
           parameter gradients sum over it (the reduce-scatter that is the
           transpose of the FSDP gather).
  'tile' — image pixel rows: each rank rasterizes a band of tile rows
           (``tile_size`` px each) of every view its data group renders.

Capacity tensors (parameters, Adam moments, alive mask, densify
accumulator) are sharded over both axes flattened: rank r keeps rows
[r C / N, (r + 1) C / N), the JAX package's flat block order (device (d, t)
holds block d * n_tile + t). Scalars (the SH degree, the Adam count) are
replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.gaussians import PARAM_FIELDS, GaussianParams, GaussianState

SPLAT_AXES = ("data", "tile")


@dataclasses.dataclass
class Mesh:
    """The ('data', 'tile') mesh of this rank: its shape, rank, coordinates
    and the process groups of its axes (None for all three without a
    process group, where the mesh is one rank)."""

    data: int
    tile: int
    rank: int
    groups: Dict[str, Optional[object]]  # 'data', 'tile', 'world'

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "tile": self.tile}

    @property
    def size(self) -> int:
        return self.data * self.tile

    @property
    def coords(self) -> Tuple[int, int]:
        """(d, t) of this rank."""
        return divmod(self.rank, self.tile)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data: int = 1, tile: int = 0) -> Mesh:
    """Build the ('data', 'tile') mesh over the world of ranks.

    tile=0 means "every remaining rank on the tile axis". Every rank must
    call it with the same shape (it creates one process group per row and
    column of the mesh, collectively)."""
    n = world_size()
    data = max(int(data), 1)
    if tile <= 0:
        if n % data:
            raise ValueError(f"{n} ranks are not divisible by data={data}")
        tile = n // data
    if data * tile != n:
        raise ValueError(
            f"mesh {data}x{tile} needs {data * tile} ranks, the world has {n}: launch "
            "one process per rank (train_cli --distributed under torchrun, or "
            "--coordinator-address / --num-processes / --process-id)")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, {"data": None, "tile": None, "world": None})
    rank = dist.get_rank()
    groups: Dict[str, Optional[object]] = {"world": dist.group.WORLD}
    # new_group is collective: every rank creates every group, in one order.
    for t in range(tile):
        g = dist.new_group([d * tile + t for d in range(data)])
        if rank % tile == t:
            groups["data"] = g
    for d in range(data):
        g = dist.new_group([d * tile + t for t in range(tile)])
        if rank // tile == d:
            groups["tile"] = g
    return Mesh(data, tile, rank, groups)


def shard_rows(mesh: Mesh, capacity: int) -> Tuple[int, int]:
    """[lo, hi): the capacity rows this rank keeps."""
    if capacity % mesh.size:
        raise ValueError(f"capacity {capacity} is not divisible by the {mesh.size} ranks of "
                         "the mesh")
    c = capacity // mesh.size
    return mesh.rank * c, (mesh.rank + 1) * c


def state_shardings(mesh: Mesh, state_like: GaussianState) -> Dict[str, object]:
    """Per leaf of a ``GaussianState`` (and its Adam moments, which follow
    the fields), the rows this rank keeps: a (lo, hi) pair for a capacity
    tensor, None for a replicated scalar."""
    rows = shard_rows(mesh, state_like.capacity)
    out: Dict[str, object] = {name: rows for name in PARAM_FIELDS}
    out.update(alive=rows, means_grad_accum=rows, active_sh_degree=None)
    return out


def shard_state(mesh: Mesh, state: GaussianState, opt_state=None):
    """This rank's shard of a full ``state`` (identical on every rank) and
    of its optimizer (a ``GaussianAdam``): new tensors; returns (state,
    opt_state), opt_state None when none is given."""
    from ..train import optimizer_with_moments

    rows = state_shardings(mesh, state)

    def cut(name, t):
        return t.detach()[slice(*rows[name]) if rows[name] else ...].clone()

    params = GaussianParams(**{name: cut(name, t) for name, t in state.params.fields()})
    shard = GaussianState(params=params, alive=cut("alive", state.alive),
                          means_grad_accum=cut("means_grad_accum", state.means_grad_accum),
                          active_sh_degree=cut("active_sh_degree", state.active_sh_degree))
    if opt_state is None:
        return shard, None
    mu, nu, count = opt_state.moments()
    opt = optimizer_with_moments(opt_state.cfg, params, {k: cut(k, v) for k, v in mu.items()},
                                 {k: cut(k, v) for k, v in nu.items()}, count)
    return shard, opt


def gather_state(mesh: Mesh, state: GaussianState, opt_state):
    """The full state and optimizer from every rank's shard (every rank
    gets the same): new tensors, the parameters trainable leaves."""
    from ..train import optimizer_with_moments
    from .collectives import all_gather_raw

    world = mesh.groups["world"]

    def full(t):
        return all_gather_raw(t.detach(), world, "state_gather")

    params = GaussianParams(**{name: full(t) for name, t in state.params.fields()})
    whole = GaussianState(params=params, alive=full(state.alive),
                          means_grad_accum=full(state.means_grad_accum),
                          active_sh_degree=state.active_sh_degree.clone())
    mu, nu, count = opt_state.moments()
    opt = optimizer_with_moments(opt_state.cfg, params, {k: full(v) for k, v in mu.items()},
                                 {k: full(v) for k, v in nu.items()}, count)
    return whole, opt


def host_to_global(mesh: Mesh, spec: Sequence, value, device=None) -> torch.Tensor:
    """What this rank stages from a host value that every rank holds whole
    and identical (the lockstep rule): its block of each dim that ``spec``
    names. ``spec[i]`` is 'data', 'tile', ('data', 'tile') (the flat mesh)
    or None (replicated) for dim i; dims past the spec are replicated."""
    x = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
    d, t = mesh.coords
    sizes = {"data": (mesh.data, d), "tile": (mesh.tile, t),
             SPLAT_AXES: (mesh.size, mesh.rank)}
    index = []
    for i, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n, k = sizes[tuple(axis) if isinstance(axis, (tuple, list)) else axis]
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of size {x.shape[i]} is not divisible by {n}")
        b = x.shape[i] // n
        index.append(slice(k * b, (k + 1) * b))
    out = x[tuple(index)]
    return out.to(device) if device is not None else out.clone()
