"""The plain objective: (1 - lambda_dssim) L1 + lambda_dssim D-SSIM and Adam
(``reference/train.py``), the objective of a configuration that names none.

The program draws one thing in its checked steps: each step's random
background, ``torch.rand(3)`` from the ``Trainer``'s generator, seeded with
``Config.seed`` on the device. The reference draws the same, then follows
the steps from the trainee on the same cameras and ground truths. The check
compares each step's loss, the first gradient's norm by leaf and the
change's norm by leaf (``compare_train``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from splatbench.inputs import LEAVES
from splatbench.reference import train as RT

CHECKS = ("loss_gap", "grad_gap", "change_gap")


def backgrounds(inputs) -> List[torch.Tensor]:
    """The program's background of each checked step."""
    g = torch.Generator(device=inputs.device).manual_seed(inputs.seed)
    return [torch.rand(3, generator=g, device=inputs.device) for _ in inputs.steps]


def reference(inputs, extra=None) -> dict:
    """The reference's checked steps, in the shape the program's are recorded
    in: each step's loss, the first gradient's norm by leaf, and the norm by
    leaf of the change over the steps. ``extra(params, i)``, where given, is
    added to step i's loss (``RT.train_steps``)."""
    c = inputs.config
    lrs = {k: float(c[f"lr_{k}"]) for k in LEAVES}
    bgs = backgrounds(inputs)
    rec = RT.train_steps(inputs.trainee, inputs.cameras, inputs.gts, bgs, lrs,
                         float(c["lambda_dssim"]), *inputs.tile, extra=extra)
    return dict(losses=rec.losses,
                grad={k: float(v.norm()) for k, v in rec.first_grad.items()},
                change={k: float((rec.params[k] - inputs.trainee[k]).norm()) for k in LEAVES})


def check(inputs) -> Dict[str, float]:
    ref = reference(inputs)
    return compare_train(inputs.program, ref["losses"], ref["grad"], ref["change"])


def compare_train(prog: dict, ref_losses, ref_grad, ref_change) -> Dict[str, float]:
    """The three numbers of a training cell's check, program against
    reference: the worst step's relative loss gap; and by the worst leaf, the
    gap between the two norms of the first gradient, and of the parameters'
    change over the checked steps, each over the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref_losses))
    med_g = float(np.median(list(ref_grad.values())))
    med_c = float(np.median(list(ref_change.values())))
    grad_gap = max(abs(prog["grad"][k] - ref_grad[k]) / max(ref_grad[k], med_g)
                   for k in ref_grad)
    moved = [k for k in ref_change if ref_grad[k] >= 1e-3 * med_g]
    change_gap = max(abs(prog["change"][k] - ref_change[k]) / max(ref_change[k], med_c)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
