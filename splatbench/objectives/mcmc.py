"""The 3DGS-MCMC objective: Kheradmand et al. 2024, "3D Gaussian Splatting
as Markov Chain Monte Carlo" (arXiv 2404.09591), with the semantics of
gsplat's ``MCMCStrategy`` (``gsplat/strategy/mcmc.py``) and its trainer's
sparsity terms, in plain float32 PyTorch, written from the paper and gsplat.

A checked step numbered s (i-th, from 1), from the trainee, every slot live:

1. Background: ``torch.rand(3)`` from a generator seeded with
   ``Config.seed`` on the device (the ``Trainer``'s), as ``plain`` draws it.
2. Loss: (1 - lambda_dssim) L1 + lambda_dssim D-SSIM (``reference/train.py``)
   of the live splats' render, + lambda_mcmc_opacity x the mean over live
   splats of sigmoid(opacity) + lambda_mcmc_scale x the mean over live
   splats and their three axes of exp(scale): gsplat's ``opacity_reg`` and
   ``scale_reg`` terms.
3. Adam (``reference/train.py``'s betas and eps, bias-corrected by Adam's own
   count); the means' rate is 3DGS's log-linear schedule from ``lr_means``
   to ``lr_means_final`` over ``lr_means_decay_steps``, taken at Adam's own
   count, which starts at 0 with the checked steps (the trainee comes with
   fresh moments).
4. Position noise: eps = ``torch.randn(C, 3)`` from the same generator, and
   means += R S^2 R^T eps x sigmoid(100 ((1 - o) - 0.995)) x mcmc_noise_lr x
   the means' rate at step s, over live splats, with R the normalised
   quaternion's rotation, S = diag(exp(scales)) and o = sigmoid(opacity),
   all after Adam (gsplat's ``inject_noise_to_position``).
5. After a step s that is a multiple of ``mcmc_refine_every`` inside
   [``warmup_densify``, ``densify_end``], a refine pass with u =
   ``torch.rand(C)`` from the same generator (``relocate``):

   - sources: the live splats with o under ``mcmc_min_opacity`` (relocation)
     and the first free slots that bring the live count to
     min(floor(live x mcmc_growth_factor), ``mcmc_cap``, C) (growth);
   - each source's target: the live non-source slot whose step of the
     cumulative opacity holds u[source] x the total (inverse CDF, the
     cumulative sum in float64: a float32 scan on the card rounds in an
     order that varies between runs);
   - a target chosen by n sources becomes r = n + 1 copies (eq. 9):
     o_new = 1 - (1 - o)^(1/r), clamped to [``mcmc_min_opacity``, 1 -
     float32 eps], and its scales times o / sum_{i=1..r} sum_{k=0..i-1}
     C(i-1, k) (-1)^k o_new^(k+1) / sqrt(k+1) (the unclamped o_new), the
     double sum taken directly in float64; each source copies its adjusted
     target; the Adam moments of every source and target are zeroed.

Departures from gsplat, each the program's documented behaviour: the copies
of one target are capped at R_MAX = 32 where gsplat caps at 51; targets are
drawn by inverse CDF on the program's uniforms where gsplat calls
``torch.multinomial``; the grown count is floor(live x mcmc_growth_factor)
with the product in float32, the configuration's precision, where gsplat
takes it in Python's double (one slot fewer at some counts: 209 for 210 at
200 live); the moments of sources are zeroed as well as of targets.

The check: ``plain.compare_train``'s three numbers, ``terms_gap`` (each
checked step's two sparsity terms, relative) and ``relocated_gap`` (each
checked pass's relocated, grown and live counts, program against reference,
over max(1, the reference's count); infinite where the program's passes
fell on other steps). The objective imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from splatbench.inputs import LEAVES
from splatbench.objectives import plain
from splatbench.reference import render as R
from splatbench.reference import train as RT

CHECKS = plain.CHECKS + ("terms_gap", "relocated_gap")
TERMS = ("loss_mcmc_opacity", "loss_mcmc_scale")
COUNTS = ("relocated", "grown", "num_live")
R_MAX = 32


def means_lr(c: dict, k: int) -> float:
    """3DGS's means rate at ``k``: log-linear from lr_means to lr_means_final
    over lr_means_decay_steps (max_iter when 0), constant without a final
    rate."""
    lr0, final = float(c["lr_means"]), float(c.get("lr_means_final", 0.0))
    decay = int(c.get("lr_means_decay_steps", 0)) or int(c["max_iter"])
    if final <= 0.0:
        return lr0
    return lr0 * (final / lr0) ** min(max(k / decay, 0.0), 1.0)


def refines_after(c: dict, s: int) -> bool:
    every = int(c["mcmc_refine_every"])
    return int(c["warmup_densify"]) <= s <= int(c["densify_end"]) and s % every == 0


def sparsity(p: Dict[str, torch.Tensor],
             alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean sigmoid(opacity), mean exp(scale)) over the live splats."""
    return (torch.sigmoid(p["opacities"][alive]).mean(),
            torch.exp(p["scales"][alive]).mean())


def rotation(quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of the (w, x, y, z) quaternions, normalised."""
    w, x, y, z = (quats / quats.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


@torch.no_grad()
def noise(p: Dict[str, torch.Tensor], alive: torch.Tensor, eps: torch.Tensor,
          scale: float) -> torch.Tensor:
    """The position noise of eps (C, 3): R S^2 R^T eps x sigmoid(100 ((1 - o)
    - 0.995)) x ``scale`` on live splats, 0 elsewhere."""
    rot = rotation(p["quats"])
    cov = R.mm(rot * torch.exp(2.0 * p["scales"])[:, None, :], rot.transpose(1, 2))
    gate = torch.sigmoid(100.0 * ((1.0 - torch.sigmoid(p["opacities"][:, 0])) - 0.995))
    return R.mm(cov, eps[:, :, None])[:, :, 0] * (gate * alive * scale)[:, None]


def scale_factor(o: torch.Tensor, o_new: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Eq. 9's factor on the scales of a splat of opacity ``o`` split into
    ``r`` copies of opacity ``o_new``: o over the double sum, in float64."""
    o, o_new = o.double(), o_new.double()
    denom = torch.zeros_like(o)
    for i in range(1, int(r.max()) + 1):
        inside = r >= i
        for k in range(i):
            term = math.comb(i - 1, k) * (-1.0) ** k / math.sqrt(k + 1.0) * o_new ** (k + 1)
            denom = denom + torch.where(inside, term, 0.0)
    return (o / denom).float()


@torch.no_grad()
def relocate(p: Dict[str, torch.Tensor], alive: torch.Tensor,
             moments: List[Dict[str, torch.Tensor]], u: torch.Tensor,
             c: dict) -> Tuple[torch.Tensor, Dict[str, int]]:
    """One refine pass on ``p`` and the Adam ``moments`` in place, with the
    uniforms ``u`` (C,); returns (the new live mask, relocated / grown /
    num_live)."""
    n = alive.shape[0]
    floor = float(c["mcmc_min_opacity"])
    o = torch.sigmoid(p["opacities"][:, 0])
    dead = alive & (o < floor)
    n_live = int(alive.sum())
    cap = min(int(c.get("mcmc_cap", 0)) or n, n)
    grown_to = int(torch.tensor(float(n_live)) * torch.tensor(float(c["mcmc_growth_factor"])))
    free = torch.nonzero(~alive)[:, 0][:max(min(grown_to, cap) - n_live, 0)]
    grow = torch.zeros_like(alive)
    grow[free] = True
    sources = torch.nonzero(dead | grow)[:, 0]
    probs = torch.where(alive & ~(dead | grow), o, 0.0)
    if not bool(probs.sum() > 0) or sources.numel() == 0:
        return alive, {"relocated": 0, "grown": 0, "num_live": n_live}
    cdf = torch.cumsum(probs.double(), dim=0)
    targets = torch.searchsorted(cdf, u[sources].double() * cdf[-1], right=True).clamp(0, n - 1)
    copies = torch.bincount(targets, minlength=n)
    hit = torch.nonzero((copies > 0) & alive)[:, 0]
    r = torch.clamp(copies[hit] + 1, max=R_MAX)
    o_hit = o[hit]
    o_new = 1.0 - (1.0 - o_hit) ** (1.0 / r.to(o.dtype))
    factor = scale_factor(o_hit, o_new, r)
    o_new = torch.clamp(o_new, floor, 1.0 - torch.finfo(torch.float32).eps)
    p["opacities"][hit, 0] = torch.logit(o_new)
    p["scales"][hit] = torch.log(torch.exp(p["scales"][hit]) * factor[:, None])
    for k in LEAVES:
        p[k][sources] = p[k][targets]
    changed = torch.cat([sources, hit])
    for m in moments:
        for k in LEAVES:
            m[k][changed] = 0.0
    new_alive = alive | grow
    return new_alive, {"relocated": int(dead.sum()), "grown": int(grow.sum()),
                       "num_live": int(new_alive.sum())}


def reference(inputs) -> dict:
    """The reference's checked steps in the shape of the program's record:
    each step's loss, the first gradient's and the change's norms by leaf,
    each step's sparsity terms, the live count after each step, and each
    refine pass's counts with its step."""
    c, dev = inputs.config, inputs.device
    lrs = {k: float(c[f"lr_{k}"]) for k in LEAVES}
    lam = float(c["lambda_dssim"])
    lam_o, lam_s = float(c["lambda_mcmc_opacity"]), float(c["lambda_mcmc_scale"])
    g = torch.Generator(device=dev).manual_seed(inputs.seed)
    p = {k: v.detach().clone().requires_grad_() for k, v in inputs.trainee.items()}
    n = p["means"].shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, terms, live, passes, first = [], [], [], [], None
    with RT.full_float32():
        for i, (s, cam, gt) in enumerate(zip(inputs.steps, inputs.cameras, inputs.gts), start=1):
            bg = torch.rand(3, generator=g, device=dev)
            img, _ = R.render({k: t[alive] for k, t in p.items()}, cam, bg, *inputs.tile)
            mo, ms = sparsity(p, alive)
            loss = RT.loss_fn(img, gt, lam) + lam_o * mo + lam_s * ms
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            terms.append({TERMS[0]: float(mo.detach()), TERMS[1]: float(ms.detach())})
            if first is None:
                first = {k: gr.detach().clone() for k, gr in zip(p, grads)}
            with torch.no_grad():
                for (k, t), gr in zip(p.items(), grads):
                    lr = means_lr(c, i - 1) if k == "means" else lrs[k]
                    m[k].mul_(RT.BETAS[0]).add_(gr, alpha=1 - RT.BETAS[0])
                    v2[k].mul_(RT.BETAS[1]).addcmul_(gr, gr, value=1 - RT.BETAS[1])
                    mhat = m[k] / (1 - RT.BETAS[0] ** i)
                    vhat = v2[k] / (1 - RT.BETAS[1] ** i)
                    t.sub_(lr * mhat / (torch.sqrt(vhat) + RT.EPS))
                eps = torch.randn((n, 3), generator=g, device=dev)
                p["means"].add_(noise(p, alive, eps,
                                      float(c["mcmc_noise_lr"]) * means_lr(c, s)))
                if refines_after(c, s):
                    u = torch.rand((n,), generator=g, device=dev)
                    alive, counts = relocate(p, alive, [m, v2], u, c)
                    passes.append(dict(counts, step=s))
            live.append(int(alive.sum()))
            del img, loss, grads
    return dict(losses=losses,
                grad={k: float(v.norm()) for k, v in first.items()},
                change={k: float((p[k].detach() - inputs.trainee[k]).norm()) for k in LEAVES},
                terms=terms, live=live, densify=passes)


def check(inputs) -> Dict[str, float]:
    ref = reference(inputs)
    prog = inputs.program
    out = plain.compare_train(prog, ref["losses"], ref["grad"], ref["change"])
    out["terms_gap"] = max(
        abs(pt[k] - rt[k]) / abs(rt[k]) if k in pt else math.inf
        for pt, rt in zip(prog["terms"], ref["terms"]) for k in TERMS)
    if [d["step"] for d in prog["densify"]] != [d["step"] for d in ref["densify"]]:
        out["relocated_gap"] = math.inf
    else:
        out["relocated_gap"] = max(
            [abs(pd[k] - rd[k]) / max(1, rd[k])
             for pd, rd in zip(prog["densify"], ref["densify"]) for k in COUNTS] or [0.0])
    return out
