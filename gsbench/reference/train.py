"""Plain PyTorch train steps of the vanilla method, from the semantics the
program states (``gstk_torch/train/step.py``, ``models/vanilla.py``,
``utils/losses.py``, ``train/optim.py``): render (:mod:`.splat`), the loss
(1 - 0.2) L1 + 0.2 (1 - SSIM) against the target (RGBA composited over
the step's random background), the gradient of every parameter group, and one
Adam step per group (torch's rule, eps 1e-15 outside the square root, dead
lanes frozen, the means' rate decayed log-linearly from 1.6e-4 to 1.6e-6
over 30,000 steps), and the refine past densification, which only culls
(:func:`cull`). It imports nothing of the program.

:func:`run_steps` follows the program's steps from a state: the drawn
scene with fresh moments for the first steps of a run, or the state the
program held before a stretch of steps after the measured window. The
image's gradient is taken whole from the loss, then pushed back into the
splats block by block (:func:`.splat.composite_backward`) and from them
into the parameters.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from gsbench.reference import splat
from gsbench.reference.precision import Arith

GROUPS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")
LRS = {"means": 1.6e-4, "features_dc": 2.5e-3, "features_rest": 2.5e-3 / 20,
       "opacities": 5e-2, "scales": 5e-3, "quats": 1e-3}
MEANS_LR_FINAL, MEANS_STEPS = 1.6e-6, 30_000
B1, B2, EPS = 0.9, 0.999, 1e-15
SSIM_LAMBDA = 0.2
# the vanilla method's refine (gstk_torch/models/vanilla.py's defaults)
REFINE_EVERY, RESET_ALPHA_EVERY, STOP_SPLIT_AT = 100, 30, 10_000
CULL_ALPHA, CULL_SCALE = 0.1, 0.5


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1]: an 11-tap Gaussian
    window (sigma 1.5) in valid mode, K1 = 0.01, K2 = 0.03."""
    c = a.shape[-1]
    win = torch.as_tensor(_window(), device=a.device)
    x = torch.cat([a, b, a * a, b * b, a * b], -1).permute(2, 0, 1)[None]
    n = x.shape[1]
    x = ar.conv2d(x, win.view(1, 1, 1, -1).repeat(n, 1, 1, 1), groups=n)
    x = ar.conv2d(x, win.view(1, 1, -1, 1).repeat(n, 1, 1, 1), groups=n)
    f = x[0].permute(1, 2, 0)
    mu_a, mu_b = f[..., :c], f[..., c:2 * c]
    s_aa = f[..., 2 * c:3 * c] - mu_a * mu_a
    s_bb = f[..., 3 * c:4 * c] - mu_b * mu_b
    s_ab = f[..., 4 * c:] - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    cs = (2 * s_ab + c2) / (s_aa + s_bb + c2)
    return (((2 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1)) * cs).mean()


def loss_of(rgb: torch.Tensor, gt: torch.Tensor, ar: Arith) -> torch.Tensor:
    diff = rgb - gt
    l1 = torch.where(diff >= 0, diff, -diff).mean()
    return (1 - SSIM_LAMBDA) * l1 + SSIM_LAMBDA * (1 - ssim(gt, rgb, ar))


def lr_at(group: str, step: int) -> torch.Tensor:
    """The group's learning rate at ``step`` (float32, as the program's
    schedules compute it)."""
    if group != "means":
        return torch.tensor(LRS[group], dtype=torch.float32)
    s = torch.tensor(float(step), dtype=torch.float32)
    t = torch.clamp(s / MEANS_STEPS, 0.0, 1.0)
    lo = torch.log(torch.tensor(LRS["means"], dtype=torch.float32))
    hi = torch.log(torch.tensor(MEANS_LR_FINAL, dtype=torch.float32))
    return torch.exp(lo * (1.0 - t) + hi * t)


# faults a control can plant where the program would be: "half" takes the
# loss over the top half of the pixels only, "altered" adds 0.02 to the
# rendered colour of the tile row at the image's middle, "cull_none" has
# the refine cull nothing and "cull_logit" has it compare the opacity's
# logit, not the opacity, with the threshold
FAULTS = ("half", "altered", "cull_none", "cull_logit")


def gradients(params: Dict[str, torch.Tensor], view: splat.View,
              target: torch.Tensor, background: torch.Tensor, sh_degree: int,
              bands: int, ar: Arith, fault: str = ""):
    """(loss, {group: gradient}) of one step's render of ``view`` against
    ``target`` (H, W, 3) in [0, 1]; ``fault`` one of :data:`FAULTS` or
    empty."""
    leaves = {k: params[k].detach().requires_grad_() for k in GROUPS}
    s = splat.project({**leaves, "alive": params["alive"]}, view, sh_degree, ar)
    lists = splat.bin_tiles(s, view, bands)
    acc, final_t, _ = splat.composite(s, lists, ar)
    acc.requires_grad_()
    final_t.requires_grad_()
    out = splat.outputs(acc, final_t, background)
    rgb = out["rgb"]
    if fault == "altered":
        rows = torch.arange(rgb.shape[0], device=rgb.device) - rgb.shape[0] // 2
        rgb = rgb + ((rows >= 0) & (rows < splat.BLOCK))[:, None, None] * 0.02
    if fault == "half":
        rgb, target = rgb[: rgb.shape[0] // 2], target[: target.shape[0] // 2]
    loss = loss_of(rgb, target, ar)
    g_acc, g_t = torch.autograd.grad(loss, [acc, final_t])
    flat = splat.Splats(*(x.detach().requires_grad_() if x.is_floating_point()
                          and i < 4 else x.detach() for i, x in enumerate(s)))
    splat.composite_backward(flat, lists, g_acc, g_t, ar)
    ups = [x.grad if x.grad is not None else torch.zeros_like(x)
           for x in flat[:4]]
    torch.autograd.backward(list(s[:4]), ups)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss.detach(), grads


def adam(params, grads, mu, nu, count: int, step: int, alive) -> None:
    """One Adam step on every group, in place; dead lanes keep their
    values and get no gradient."""
    dev = alive.device
    count_f = torch.tensor(float(count), device=dev)
    c1 = 1.0 - B1 ** count_f
    c2 = 1.0 - B2 ** count_f
    for k in GROUPS:
        lane = alive.reshape(alive.shape + (1,) * (params[k].ndim - 1))
        g = torch.where(lane, grads[k], 0.0)
        mu[k] = B1 * mu[k] + (1 - B1) * g
        nu[k] = B2 * nu[k] + (1 - B2) * g * g
        lr = lr_at(k, step).to(g.device)
        upd = lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
        params[k] = params[k] - torch.where(lane, upd, 0.0)


@torch.no_grad()
def cull(params: Dict[str, torch.Tensor], step: int, fault: str = "") -> None:
    """The refine at the state's ``step`` (the steps taken so far) past
    densification, in place: alive Gaussians whose opacity is under
    ``CULL_ALPHA``, and, past the first opacity reset, those whose largest
    world scale is over ``CULL_SCALE``, are no longer alive; nothing else
    changes. Before ``STOP_SPLIT_AT`` the refine also densifies and resets
    opacities, which this reference does not follow."""
    if step < STOP_SPLIT_AT:
        raise ValueError(f"step {step}: the refine densifies before {STOP_SPLIT_AT}")
    if fault == "cull_none":
        return
    op = params["opacities"][:, 0]
    low = (op if fault == "cull_logit" else torch.sigmoid(op)) < CULL_ALPHA
    big = torch.exp(params["scales"]).amax(-1) > CULL_SCALE
    past_reset = step > REFINE_EVERY * RESET_ALPHA_EVERY
    params["alive"] = params["alive"] & ~(low | (big & past_reset))


def run_steps(params: Dict[str, torch.Tensor], views: Sequence[splat.View],
              targets: Sequence[torch.Tensor], backgrounds: Sequence[torch.Tensor],
              first_step: int, sh_degree: int, bands: int, ar: Arith,
              fault: str = "", moments=None, count: int = 0) -> Dict:
    """Train ``len(views)`` steps from ``params`` at the state's step
    ``first_step``, with Adam's moments ``moments = (mu, nu)`` after
    ``count`` steps (fresh moments when None), and the refine's cull after
    each step that ends a ``REFINE_EVERY``; return the losses, the first
    step's gradient norms by group, the parameters' change by group, and
    the alive lanes and opacity logits at the end."""
    start = {k: params[k].clone() for k in GROUPS}
    params = dict(params)
    if moments is None:
        mu = {k: torch.zeros_like(params[k]) for k in GROUPS}
        nu = {k: torch.zeros_like(params[k]) for k in GROUPS}
    else:
        mu = {k: moments[0][k].clone() for k in GROUPS}
        nu = {k: moments[1][k].clone() for k in GROUPS}
    losses: List[float] = []
    grad_norms = {}
    for i, (view, tgt, bg) in enumerate(zip(views, targets, backgrounds)):
        # a tensor divisor: on the card a host scalar divides by its reciprocal
        gt = tgt.to(torch.float32) / torch.full((), 255.0, device=tgt.device)
        if gt.shape[-1] == 4:  # RGBA over the step's background
            a = gt[..., 3:4]
            gt = a * gt[..., :3] + (1.0 - a) * bg
        loss, grads = gradients(params, view, gt, bg, sh_degree, bands, ar, fault)
        losses.append(float(loss))
        if i == 0:
            alive = params["alive"]
            grad_norms = {k: float(torch.linalg.norm(torch.where(
                alive.reshape(alive.shape + (1,) * (g.ndim - 1)), g, 0.0
            ).double())) for k, g in grads.items()}
        adam(params, grads, mu, nu, count + i + 1, first_step + i, params["alive"])
        del grads
        if (first_step + i + 1) % REFINE_EVERY == 0:
            cull(params, first_step + i + 1, fault)
    change = {k: float(torch.linalg.norm((params[k] - start[k]).double()))
              for k in GROUPS}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "alive": params["alive"], "opacities": params["opacities"][:, 0]}
