"""Weights across the two packages: flax parameter trees <-> state dicts.

The JAX package's diffusion params are nested dicts of arrays (a flax
variables dict per module, ``{"params": {...}}``), handed over as numpy
(``jax.device_get``). Two topologies:

- the tiny modules (``unet.py``, ``vae.py``, ``model_diffusion.py``) carry
  flax's auto-names (``Conv_0``, ``ResnetBlock_1``, ``Dense_2``, ...); each
  port module lists its children in flax's creation order
  (``flax_children``), and leaves are ``nn.Conv2d`` ("Conv"),
  ``nn.Linear`` ("Dense") and ``nn.GroupNorm``;
- the SD modules (``sd_unet.py``, ``sd_vae.py``, ``sd_clip.py``) carry the
  diffusers names; a flax path maps to its state-dict key by the JAX
  package's ``_torch_key`` rule (list entries ``down_blocks_0`` become
  ``down_blocks.0``).

Layouts: conv kernels HWIO <-> OIHW, dense kernels (in, out) <-> (out, in),
norm ``scale`` <-> ``weight``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

# flax name components that are diffusers ModuleList entries: "name_3" in the
# flax tree is "name.3" in the state dict. "linear_1", "norm1", ... are not.
_LIST_NAMES = (
    "down_blocks", "up_blocks", "mid_block", "resnets", "attentions",
    "transformer_blocks", "downsamplers", "upsamplers", "net", "to_out",
    "layers",
)
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}


def torch_key(flax_path: Tuple[str, ...]) -> str:
    """flax param path -> diffusers / transformers state-dict key."""
    parts = []
    for comp in flax_path[:-1]:
        if comp == "params":
            continue
        for sub in comp.split("."):
            for ln in _LIST_NAMES:
                if sub.startswith(ln + "_") and sub[len(ln) + 1:].isdigit():
                    sub = f"{ln}.{sub[len(ln) + 1:]}"
                    break
            parts.append(sub)
    return ".".join(parts + [_LEAF_NAMES[flax_path[-1]]])


def _to_torch_layout(leaf: str, w: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and w.ndim == 4:  # HWIO -> OIHW
        return w.transpose(3, 2, 0, 1)
    if leaf == "kernel" and w.ndim == 2:
        return w.T
    return w


def _to_flax_layout(leaf: str, w: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and w.ndim == 4:  # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0)
    if leaf == "kernel" and w.ndim == 2:
        return w.T
    return w


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def sd_state_dict(flax_params) -> Dict[str, torch.Tensor]:
    """The state dict of an SD-topology port module (``sd_unet``,
    ``sd_vae``, ``sd_clip``) from the JAX module's params."""
    return {torch_key(p): torch.tensor(_to_torch_layout(p[-1], np.asarray(w, np.float32)))
            for p, w in _leaves(flax_params)}


# -- the tiny topology: flax auto-names ------------------------------------------


def _leaf_params(mod: nn.Module) -> Dict[str, torch.Tensor]:
    """flax leaf name -> the torch parameter of a Conv / Dense / GroupNorm."""
    if isinstance(mod, (nn.Conv2d, nn.Linear)):
        out = {"kernel": mod.weight}
    elif isinstance(mod, nn.GroupNorm):
        out = {"scale": mod.weight}
    else:
        raise TypeError(f"{type(mod).__name__} has no flax counterpart")
    if mod.bias is not None:
        out["bias"] = mod.bias
    return out


def _walk(mod: nn.Module, path=()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(flax path, torch parameter) for every parameter below ``mod``."""
    if hasattr(mod, "flax_children"):
        for name, child in mod.flax_children():
            yield from _walk(child, path + (name,))
    else:
        for leaf, p in _leaf_params(mod).items():
            yield path + (leaf,), p


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"flax params lack {'/'.join(path)}")
        tree = tree[k]
    return tree


def tiny_state_dict(module: nn.Module, flax_variables) -> Dict[str, torch.Tensor]:
    """The state dict of a tiny-topology port ``module`` from the JAX
    module's variables (``{"params": ...}``); every flax leaf must be used."""
    names = {id(p): k for k, p in module.named_parameters()}
    params = flax_variables["params"]
    sd, used = {}, set()
    for path, p in _walk(module):
        w = _to_torch_layout(path[-1], np.asarray(_get(params, path), np.float32))
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {w.shape} != the port's {tuple(p.shape)}")
        sd[names[id(p)]] = torch.tensor(w)
        used.add(path)
    extra = [p for p, _ in _leaves(params) if p not in used]
    if extra:
        raise KeyError(f"flax params with no place in the port: {extra[:10]}")
    return sd


def tiny_flax_variables(module: nn.Module) -> Dict[str, Any]:
    """The JAX module's variables dict (numpy leaves) from a tiny-topology
    port ``module``: the inverse of ``tiny_state_dict``."""
    tree: Dict[str, Any] = {}
    for path, p in _walk(module):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(
            _to_flax_layout(path[-1], p.detach().to("cpu", torch.float32).numpy()))
    return {"params": tree}


def load_jax_params(pipe, params: Dict[str, Any]) -> None:
    """Copy the JAX pipeline's ``params`` (``{"fe", "fa", "em", "unet",
    "vae"}``, numpy leaves) into the port's pipeline ``pipe``, in place."""
    for part, mod in pipe.parts().items():
        if part not in params:
            raise KeyError(f"the JAX params lack the pipeline part {part!r}")
        sd = (sd_state_dict(params[part]) if getattr(mod, "sd_topology", False)
              else tiny_state_dict(mod, params[part]))
        mod.load_state_dict(sd, strict=True)
