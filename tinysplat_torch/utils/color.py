"""Color <-> SH DC coefficient conversion.

Copy of ``tinysplat_tpu.utils.color`` (C0 = Y_0^0 constant). Works on numpy
arrays and torch tensors alike.
"""

SH_C0 = 0.28209479177387814


def RGB2SH(rgb):
    return (rgb - 0.5) / SH_C0


def SH2RGB(sh):
    return sh * SH_C0 + 0.5
