from .color import RGB2SH, SH2RGB
from .device import resolve_device
from .quaternions import normalize_quat, quat_to_rotmat, random_quats

__all__ = ["RGB2SH", "SH2RGB", "resolve_device", "normalize_quat",
           "quat_to_rotmat", "random_quats"]
