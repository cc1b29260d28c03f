"""Pretrained weights: diffusers / transformers directories -> modules.

Torch port of ``tinysplat_tpu.diffusion.port``. Reads a local
diffusers-format model directory, offline:

    unet/config.json + diffusion_pytorch_model.safetensors (or .bin)
    vae/config.json  + diffusion_pytorch_model.safetensors (or .bin)

The SD modules (``sd_unet.py``, ``sd_vae.py``, ``sd_clip.py``) name their
submodules as diffusers / transformers do, so loading is
``load_state_dict`` on the keyed module; every tensor is upcast to float32.
A checkpoint tensor with no place in the module, and a module tensor the
checkpoint lacks, are reported as the JAX package reports them (a warning
naming three; a KeyError naming ten).

The safetensors reader and writer are first-party: the format is an 8-byte
little-endian header length, a JSON table of (dtype, shape, byte offsets)
and the raw little-endian buffer.
"""
from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device

log = logging.getLogger(__name__)

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": None,  # through a uint16 view, below
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_WRITE_DTYPES = {"F32": "<f4", "F16": "<f2"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Parse a .safetensors file into numpy arrays of their stored dtype
    (BF16 widened to float32)."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            lo, hi = meta["data_offsets"]
            f.seek(base + lo)
            raw = f.read(hi - lo)
            if meta["dtype"] == "BF16":
                arr = (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)
            else:
                arr = np.frombuffer(raw, _SAFETENSORS_DTYPES[meta["dtype"]])
            out[name] = arr.reshape(meta["shape"]).copy()
    return out


def write_safetensors(path: str, tensors: Mapping[str, Any], dtype: str = "F32") -> None:
    """Write ``tensors`` (name -> numpy array or tensor) as a .safetensors
    file with every tensor stored as ``dtype`` ("F32" or "F16"). The header
    is padded with spaces to a multiple of 8 bytes, as the reference writer
    pads it."""
    if dtype not in _WRITE_DTYPES:
        raise ValueError(f"dtype {dtype!r}: one of {sorted(_WRITE_DTYPES)}")
    arrays = {}
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor):
            t = t.detach().to("cpu", torch.float32).numpy()
        arrays[name] = np.ascontiguousarray(np.asarray(t).astype(_WRITE_DTYPES[dtype]))
    header, off = {}, 0
    for name, a in arrays.items():
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    hj = json.dumps(header).encode()
    hj += b" " * (-len(hj) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for a in arrays.values():
            f.write(a.tobytes())


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """A diffusers model directory's state dict (safetensors or .bin), as
    float32 CPU tensors."""
    st = os.path.join(model_dir, "diffusion_pytorch_model.safetensors")
    if os.path.exists(st):
        return {k: torch.from_numpy(v.astype(np.float32)) for k, v in
                read_safetensors(st).items()}
    bin_path = os.path.join(model_dir, "diffusion_pytorch_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in sd.items()}
    raise FileNotFoundError(f"no diffusers weights in {model_dir}")


def load_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_into(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load ``sd`` into ``model`` (built on the meta device: the tensors are
    assigned, not copied). A missing tensor raises; unused checkpoint
    tensors are logged."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"missing torch weights for: {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    unused = sorted(set(sd) - set(own))
    if unused:
        log.warning("%d checkpoint tensors had no place in the port's topology "
                    "(e.g. %s) — the ported model may omit semantics the "
                    "checkpoint was trained with", len(unused), unused[:3])
    model.load_state_dict({k: sd[k].to(torch.float32) for k in own}, assign=True)
    return model


def _build_and_load(cls, cfg, sd, device):
    with torch.device("meta"):
        model = cls(cfg)
    return load_into(model, sd).to(device).eval()


def load_unet(model_dir: str, device="cuda"):
    """``UNet2DConditionModel`` with the weights of a diffusers unet/
    directory, on ``device``."""
    from .sd_unet import UNet2DConditionModel

    device = resolve_device(device)
    return _build_and_load(UNet2DConditionModel, load_config(model_dir),
                           load_state_dict(model_dir), device)


def load_vae(model_dir: str, device="cuda"):
    """``SDAutoencoderKL`` with the weights of a diffusers vae/ directory
    (the pre-0.16 attention names too), on ``device``."""
    from .sd_vae import SDAutoencoderKL, rename_legacy_keys

    device = resolve_device(device)
    return _build_and_load(SDAutoencoderKL, load_config(model_dir),
                           rename_legacy_keys(load_state_dict(model_dir)), device)


def load_text_encoder(model_dir: str, device="cuda"):
    """``CLIPTextModel`` from a transformers text_encoder/ directory
    (model.safetensors or pytorch_model.bin + config.json), on ``device``."""
    from .sd_clip import CLIPTextModel

    device = resolve_device(device)
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in read_safetensors(st).items()}
    else:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                        weights_only=True)
    # transformers may or may not carry the "text_model." prefix, by whether
    # the saved object was CLIPTextModel or its .text_model.
    if not any(k.startswith("text_model.") for k in sd):
        sd = {f"text_model.{k}": v for k, v in sd.items()}
    sd.pop("text_model.embeddings.position_ids", None)
    return _build_and_load(CLIPTextModel, load_config(model_dir), sd, device)
