"""The SuGaR density objective: Guédon & Lepetit 2024, "SuGaR:
Surface-Aligned Gaussian Splatting for Efficient 3D Mesh Reconstruction"
(arXiv 2311.12775), as maxgillett/tinysplat trains it: the plain loss plus
``lambda_density`` x the density term of ``reference/density.py`` inside
its window, in plain float32 PyTorch.

A checked step numbered s (i-th, from 1), from the trainee, every slot live:

1. Probe: on the first checked step, and on every step with s %
   ``interval_densify`` == 1, the probe is rebuilt from the parameters the
   step starts from: u = ``torch.rand(density_samples)`` then eps =
   ``torch.randn(density_samples, 3)``, both from a generator seeded with
   ``Config.seed`` on the device (the ``Trainer``'s), before the step's
   background. Each u picks the splat whose step of the cumulative
   ``area_weights`` (in float64) holds u x the total; the points
   (``sample``) and their 16 neighbours (``knn``) are kept until the next
   rebuild.
2. Background: ``torch.rand(3)`` from the same generator, as ``plain``.
3. Loss: (1 - lambda_dssim) L1 + lambda_dssim D-SSIM of the render's colour
   (``reference/train.py``), + lambda_density x the term on the render's
   depth (``reference/density.term``) when ``regularize_density_start`` <= s
   < ``regularize_density_end``.
4. Adam as in ``reference/train.py``: betas (0.9, 0.999), eps 1e-8, bias
   correction by Adam's own count, one constant rate a leaf (the mix sets
   no means decay).

The window's first step prunes every splat under opacity 0.5 in the
program; the reference does not follow it, and refuses checked steps that
hold the window's start.

The check: ``plain.compare_train``'s three numbers; ``terms_gap``, each
checked step's ``loss_density`` relative to the reference's (infinite
where the program reported none); ``knn_gap``, the share of the probe's
rows whose 16-neighbour set differs from the reference's (infinite where
the program's rebuilds fell on other steps), of the last rebuild in the
checked steps: the program's table is the ``knn_idx`` of its newest
``probe_history`` entry, and a record without one is refused (ValueError).
The objective imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from splatbench.inputs import LEAVES
from splatbench.objectives import plain
from splatbench.reference import density as RD
from splatbench.reference import train as RT

CHECKS = plain.CHECKS + ("terms_gap", "knn_gap")
TERM = "loss_density"


def in_window(c: dict, s: int) -> bool:
    return int(c["regularize_density_start"]) <= s < int(c["regularize_density_end"])


def rebuilds_at(c: dict, s: int, first: bool) -> bool:
    """Whether step ``s`` rebuilds the probe (the first checked step always)."""
    return in_window(c, s) and (first or s % max(int(c["interval_densify"]), 1) == 1)


@torch.no_grad()
def probe(p: Dict[str, torch.Tensor], alive: torch.Tensor, samples: int,
          g: torch.Generator):
    """(points (S, 3), neighbours (S, 16)) of step 1, drawing from ``g``."""
    dev = p["means"].device
    u = torch.rand((samples,), generator=g, device=dev)
    cdf = torch.cumsum(RD.area_weights(p, alive).double(), dim=0)
    idxs = torch.searchsorted(cdf, u.double() * cdf[-1], right=True)
    idxs = idxs.clamp(0, alive.shape[0] - 1)
    eps = torch.randn((samples, 3), generator=g, device=dev)
    points = RD.sample(p, idxs, eps)
    return points, RD.knn(points, p["means"], alive)


def reference(inputs) -> dict:
    """The reference's checked steps in the shape of the program's record:
    each step's loss, the first gradient's and the change's norms by leaf,
    each step's density term, and each rebuild's step and neighbour table."""
    c, dev = inputs.config, inputs.device
    start = int(c["regularize_density_start"])
    if start in inputs.steps:
        raise ValueError(f"the checked steps {inputs.steps} hold the window's start {start}, "
                         "whose opacity-0.5 prune the reference does not follow")
    lrs = {k: float(c[f"lr_{k}"]) for k in LEAVES}
    lam, lam_d = float(c["lambda_dssim"]), float(c["lambda_density"])
    g = torch.Generator(device=dev).manual_seed(inputs.seed)
    p = {k: v.detach().clone().requires_grad_() for k, v in inputs.trainee.items()}
    alive = torch.ones(p["means"].shape[0], dtype=torch.bool, device=dev)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, terms, probes, first = [], [], [], None
    points = neighbours = None
    with RT.full_float32():
        for i, (s, cam, gt) in enumerate(zip(inputs.steps, inputs.cameras, inputs.gts), start=1):
            if rebuilds_at(c, s, first=points is None):
                points, neighbours = probe(p, alive, int(c["density_samples"]), g)
                probes.append({"step": s, "knn_idx": neighbours})
            bg = torch.rand(3, generator=g, device=dev)
            img, depth = RD.render(p, cam, bg, *inputs.tile)
            loss = RT.loss_fn(img, gt, lam)
            step_terms = {}
            if in_window(c, s):
                term = RD.term(points, neighbours, p, depth, cam)
                loss = loss + lam_d * term
                step_terms[TERM] = float(term.detach())
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            terms.append(step_terms)
            if first is None:
                first = {k: gr.detach().clone() for k, gr in zip(p, grads)}
            with torch.no_grad():
                for (k, t), gr in zip(p.items(), grads):
                    m[k].mul_(RT.BETAS[0]).add_(gr, alpha=1 - RT.BETAS[0])
                    v2[k].mul_(RT.BETAS[1]).addcmul_(gr, gr, value=1 - RT.BETAS[1])
                    mhat = m[k] / (1 - RT.BETAS[0] ** i)
                    vhat = v2[k] / (1 - RT.BETAS[1] ** i)
                    t.sub_(lrs[k] * mhat / (torch.sqrt(vhat) + RT.EPS))
            del img, depth, loss, grads
    return dict(losses=losses,
                grad={k: float(v.norm()) for k, v in first.items()},
                change={k: float((p[k].detach() - inputs.trainee[k]).norm()) for k in LEAVES},
                terms=terms, probe=probes)


def knn_gap(prog_probes, ref_probes) -> float:
    """The share of the last rebuild's rows whose neighbour sets differ (the
    program keeps the table of its newest rebuild only); infinite where the
    rebuilds fell on other steps."""
    if [e["step"] for e in prog_probes] != [e["step"] for e in ref_probes]:
        return math.inf
    if ref_probes and "knn_idx" not in prog_probes[-1]:
        raise ValueError("the program's probe record holds no neighbour table (knn_idx): "
                         "its density probe cannot be checked")
    if not ref_probes:
        return 0.0
    want = ref_probes[-1]["knn_idx"]
    got = prog_probes[-1]["knn_idx"].to(want.device)
    if got.shape != want.shape:
        return math.inf
    differ = torch.sort(got, dim=1).values != torch.sort(want, dim=1).values
    return float(differ.any(dim=1).double().mean())


def check(inputs) -> Dict[str, float]:
    ref = reference(inputs)
    prog = inputs.program
    out = plain.compare_train(prog, ref["losses"], ref["grad"], ref["change"])
    out["terms_gap"] = max(
        [abs(pt[TERM] - rt[TERM]) / abs(rt[TERM]) if TERM in pt else math.inf
         for pt, rt in zip(prog["terms"], ref["terms"]) if TERM in rt] or [0.0])
    out["knn_gap"] = knn_gap(prog["probe"], ref["probe"])
    return out
