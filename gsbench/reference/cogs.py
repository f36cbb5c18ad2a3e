"""Plain PyTorch train steps of co-gs with SO(3) x R3 camera optimisation,
and its refine with densification, from the semantics the program states
(``gstk_torch/models/depth.py``, ``utils/losses.py``,
``core/camera_opt.py``, ``train/step.py``, ``train/strategy.py``). It
imports nothing of the program; the render, the RGB loss and the scene's
Adam are the vanilla reference's (:mod:`.splat`, :mod:`.train`).

One step at the state's step ``s``, on a train view whose camera carries
the adjustment ``a = (t, omega)`` of its index:

* the camera: ``c2w @ [exp(omega) | t]`` (SO(3) x R3, right-multiplied),
  the rotation by Rodrigues' formula (``I + omega^`` under an angle of
  1e-6); the render as :func:`.splat.project`'s with the view's matrices
  differentiable in the adjusted ``c2w``, the SH view directions from its
  position held constant, as the program holds them;
* the loss: (1 - 0.2) L1 + 0.2 (1 - SSIM) of the RGB against the target
  over the step's random background; ``0.1 [s > 6000] [s < 25000]`` times
  the mean |depth - sensor depth| over the pixels whose sensor depth is not
  0 (the depth: accumulated depth over alpha, the largest accumulated depth
  where alpha is 0); ``10 [s > 10000]`` times the planar prior: 16 patches
  of 128 x 128 pixels at origins drawn from the step's generator after the
  background (x0 in [0, W - 128), then y0 in [0, H - 128)), each patch's
  points ``((x - cx) d / fx, (y - cy) d / fy, d)`` centred, their
  covariance plus 1e-12 I, the eigenvector of its smallest eigenvalue as
  the plane's normal, the mean |distance| to the plane; and the pose
  penalty, 1e-2 times the mean |t| plus 1e-3 times the mean |omega| over
  every camera (each norm with 1e-24 under the root); every |x| is the
  select ``x if x >= 0 else -x``;
* Adam on the scene's groups as :func:`.train.adam`, and on the camera
  group: the same rule, no lane mask, its rate decayed log-linearly from
  1e-3 to 5e-5 over 30,000 steps;
* the densify statistics: each lane's screen-space gradient norm and
  whether it was drawn, summed, and its largest radius over 800;
* after a step that ends a refine period, the refine at the new step: an
  average screen gradient over 2e-4 selects a lane; one whose largest
  scale exceeds 0.01 splits into two children (the mean plus its rotated,
  scaled normal draws, the scale over 1.6), another is copied; the cull
  (opacity under 0.1, past the first reset a largest scale over 0.5) and
  the split parents leave their lanes; the valid children (the parent's
  opacity at 0.1 or more, and past the first reset a child's largest
  scale at 0.5 or under), the first split sample of every parent in lane
  order, then the second, then the copies, fill the free lanes in lane
  order; their moments start at 0. The normal draws are ``(2, C, 3)`` from
  the step's generator. Densification runs while ``s < 25000`` and
  ``s % 3000 > 310`` (210 train views + 100) past the warm-up of 500.

Departures from the published co-gs (``depth_gs.py:39-145``,
``cogs_pipeline.py:60-77``) are the program's: ``main_loss`` stays
vanilla's and the sensor term is weighted by ``depth_lambda``; the planar
prior is a least-squares plane per patch, not the published RANSAC fit;
the camera group, which the published pipeline registers but its splat
models never apply, is applied and penalised; the refine keeps a fixed
capacity, so children past the free lanes are dropped.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from gsbench.reference import splat
from gsbench.reference import train as rtrain
from gsbench.reference.precision import Arith, strict_f32

GROUPS = rtrain.GROUPS
CAMERA = "camera_opt"
DEPTH_LAMBDA, DEPTH_START, DEPTH_STOP = 0.1, 6_000, 25_000
PLANAR_WEIGHT, PLANAR_START, PATCH, PATCHES = 10.0, 10_000, 128, 16
CAM_LR, CAM_LR_FINAL, CAM_STEPS = 1e-3, 5e-5, 30_000
TRANS_PENALTY, ROT_PENALTY = 1e-2, 1e-3
# co-gs's refine (gstk_torch/models/depth.py over vanilla.py's defaults)
WARMUP, STOP_SPLIT_AT, STOP_SCREEN_SIZE_AT = 500, 25_000, 8_000
DENSIFY_GRAD, DENSIFY_SIZE, SPLIT_SAMPLES = 2e-4, 0.01, 2
CULL_SCREEN, SPLIT_SCREEN = 0.15, 0.05
RESET_EVERY = rtrain.REFINE_EVERY * rtrain.RESET_ALPHA_EVERY

# faults a control can plant where the program would be, beside the vanilla
# ones (:data:`.train.FAULTS`): "depth_dropped" leaves the sensor term out,
# "planar_largest" takes the plane's normal from the largest eigenvalue,
# "camera_frozen" steps the camera group by nothing, and "densify_skipped"
# has the refine write no children (the split parents still leave)
FAULTS = rtrain.FAULTS + ("depth_dropped", "planar_largest", "camera_frozen",
                          "densify_skipped")


def _abs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, -x)


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def adjusted_c2w(c2w: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``c2w`` (3, 4) right-multiplied by the SO(3) x R3 exponential of
    ``adj`` (6,) = (t, omega)."""
    t, w = adj[:3], adj[3:]
    theta = torch.sqrt((w * w).sum() + 1e-24)
    th = torch.clamp(theta, min=1e-8)
    k = _skew(w)
    eye = torch.eye(3, dtype=adj.dtype, device=adj.device)
    big = eye + (torch.sin(th) / th) * k + ((1.0 - torch.cos(th)) / (th * th)) * (k @ k)
    rot = torch.where(theta > 1e-6, big, eye + k)
    r0 = c2w[:, :3]
    return torch.cat([r0 @ rot, (r0 @ t + c2w[:, 3])[:, None]], 1)


def pose_penalty(adj: torch.Tensor) -> torch.Tensor:
    norm = lambda x: torch.sqrt((x * x).sum(-1) + 1e-24)
    return (norm(adj[:, :3]).mean() * TRANS_PENALTY
            + norm(adj[:, 3:]).mean() * ROT_PENALTY)


def camera_lr(step: int) -> torch.Tensor:
    """The camera group's rate at ``step``, float32."""
    t = torch.clamp(torch.tensor(float(step)) / CAM_STEPS, 0.0, 1.0)
    lo = torch.log(torch.tensor(CAM_LR, dtype=torch.float32))
    hi = torch.log(torch.tensor(CAM_LR_FINAL, dtype=torch.float32))
    return torch.exp(lo * (1.0 - t) + hi * t)


def project(params: Dict[str, torch.Tensor], view: splat.View,
            c2w: torch.Tensor, sh_degree: int, ar: Arith) -> splat.Splats:
    """:func:`.splat.project` of every lane into ``view`` seen from
    ``c2w``, differentiable in the parameters and in ``c2w`` (not through
    the SH view directions)."""
    means = params["means"]
    q = params["quats"]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    scales = torch.exp(params["scales"])
    viewmat, fullmat = splat.camera_matrices(view._replace(c2w=c2w))
    rot = splat._quat_rot(q) * scales[:, None, :]
    cov3d = ar.matmul(rot, rot.transpose(1, 2))
    wmat, tvec = viewmat[:3, :3], viewmat[:3, 3]
    t = ar.matmul(means, wmat.T) + tvec
    tz = t[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    lim_x = 1.3 * 0.5 * view.width / view.fx
    lim_y = 1.3 * 0.5 * view.height / view.fy
    tx = tz * torch.clamp(t[:, 0] / tz_safe, -lim_x, lim_x)
    ty = tz * torch.clamp(t[:, 1] / tz_safe, -lim_y, lim_y)
    zeros = torch.zeros_like(tz)
    jac = torch.stack([
        view.fx / tz_safe, zeros, -view.fx * tx / (tz_safe * tz_safe),
        zeros, view.fy / tz_safe, -view.fy * ty / (tz_safe * tz_safe),
    ], -1).reshape(-1, 2, 3)
    tmat = ar.matmul(jac, wmat)
    cov2d = ar.matmul(ar.matmul(tmat, cov3d), tmat.transpose(1, 2))
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv, -b * inv, a * inv], -1)
    half = 0.5 * (a + c)
    vmax = half + torch.sqrt(torch.clamp(half * half - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(vmax, min=0.0))).detach()
    hom = ar.matmul(torch.cat([means, torch.ones_like(means[:, :1])], -1),
                    fullmat.T)
    rw = 1.0 / (hom[:, 3] + 1e-6)
    xys = torch.stack([0.5 * view.width * hom[:, 0] * rw - 0.5 + view.cx,
                       0.5 * view.height * hom[:, 1] * rw - 0.5 + view.cy], -1)
    tiles = ((view.width + splat.BLOCK - 1) // splat.BLOCK,
             (view.height + splat.BLOCK - 1) // splat.BLOCK)
    lo, hi = splat.tile_box(xys.detach(), torch.stack([radius, radius], -1), tiles, 0)
    drawn = ((hi - lo).prod(-1) > 0) & (tz >= splat.NEAR) & ok & params["alive"]
    dirs = means.detach() - c2w[:, 3].detach()
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-12)
    coeffs = torch.cat([params["features_dc"][:, None], params["features_rest"]], 1)
    rgb = torch.clamp(splat.sh_colors(sh_degree, dirs, coeffs, ar) + 0.5, min=0.0)
    op = torch.sigmoid(params["opacities"][:, 0])
    d = drawn[:, None]
    return splat.Splats(
        xys=torch.where(d, xys, 0.0),
        conics=torch.where(d, conics, 0.0),
        opacities=torch.where(drawn, op, 0.0),
        colors=torch.cat([rgb, torch.where(drawn, tz, 0.0)[:, None]], -1),
        depths=torch.where(drawn, tz, 0.0).detach(),
        radii=torch.where(drawn, radius, 0.0),
    )


def patch_origins(generator: torch.Generator, height: int, width: int,
                  device) -> tuple:
    """The planar prior's 16 patch origins, drawn as the program draws
    them: x0 in [0, max(W - P, 1)), then y0, P = min(128, min(H, W) // 2)."""
    p = min(PATCH, min(height, width) // 2)
    x0 = torch.randint(0, max(width - p, 1), (PATCHES,), generator=generator,
                       device=device)
    y0 = torch.randint(0, max(height - p, 1), (PATCHES,), generator=generator,
                       device=device)
    return x0, y0


def planar(depth: torch.Tensor, view: splat.View, origins, ar: Arith,
           largest: bool = False) -> torch.Tensor:
    """The mean point-to-plane distance of the patches at ``origins``."""
    h, w = depth.shape
    p = min(PATCH, min(h, w) // 2)
    x0 = torch.clamp(origins[0], 0, max(w - p, 0))
    y0 = torch.clamp(origins[1], 0, max(h - p, 0))
    r = torch.arange(p, device=depth.device)
    d = depth[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]
    u = ((x0[:, None, None] + r[None, None, :]).to(torch.float32) - view.cx) / view.fx
    v = ((y0[:, None, None] + r[None, :, None]).to(torch.float32) - view.cy) / view.fy
    pts = torch.stack([u * d, v * d, d], -1).reshape(d.shape[0], -1, 3)
    centred = pts - pts.mean(1, keepdim=True)
    cov = ar.matmul(centred.transpose(1, 2), centred) / pts.shape[1]
    eye = torch.eye(3, device=depth.device)
    _, vecs = torch.linalg.eigh(cov + 1e-12 * eye)
    normal = vecs[:, :, 2 if largest else 0]
    return _abs((centred * normal[:, None, :]).sum(-1)).mean(-1).mean()


def depth_l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    valid = (gt > 0).to(pred.dtype)
    return (_abs(pred - gt) * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def gradients(params: Dict[str, torch.Tensor], adjust: torch.Tensor, index: int,
              view: splat.View, target: torch.Tensor, depth: torch.Tensor,
              background: torch.Tensor, origins, step: int, sh_degree: int,
              bands: int, ar: Arith, fault: str = "") -> Dict:
    """One co-gs step's forward and backward on train view ``index``
    (``target`` (H, W, 3) over the background, ``depth`` (H, W)): the
    loss, the gradients by group (the camera group's under
    :data:`CAMERA`), the screen-space gradient and the radii."""
    leaves = {k: params[k].detach().requires_grad_() for k in GROUPS}
    cam = adjust.detach().requires_grad_()
    c2w = adjusted_c2w(view.c2w.to(torch.float32), cam[index])
    s = project({**leaves, "alive": params["alive"]}, view, c2w, sh_degree, ar)
    lists = splat.bin_tiles(s, view, bands)
    acc, final_t, _ = splat.composite(s, lists, ar)
    acc.requires_grad_()
    final_t.requires_grad_()
    out = splat.outputs(acc, final_t, background)
    rgb, gt = out["rgb"], target
    if fault == "altered":
        rows = torch.arange(rgb.shape[0], device=rgb.device) - rgb.shape[0] // 2
        rgb = rgb + ((rows >= 0) & (rows < splat.BLOCK))[:, None, None] * 0.02
    if fault == "half":
        rgb, gt = rgb[: rgb.shape[0] // 2], gt[: gt.shape[0] // 2]
    loss = rtrain.loss_of(rgb, gt, ar)
    if fault != "depth_dropped":
        gate = float(DEPTH_START < step < DEPTH_STOP)
        loss = loss + DEPTH_LAMBDA * gate * depth_l1(out["depth"], depth)
    loss = loss + float(step > PLANAR_START) * PLANAR_WEIGHT * planar(
        out["depth"], view, origins, ar, largest=fault == "planar_largest")
    loss = loss + pose_penalty(cam)
    g_acc, g_t, g_cam = torch.autograd.grad(loss, [acc, final_t, cam])
    flat = splat.Splats(*(x.detach().requires_grad_() if x.is_floating_point()
                          and i < 4 else x.detach() for i, x in enumerate(s)))
    splat.composite_backward(flat, lists, g_acc, g_t, ar)
    ups = [x.grad if x.grad is not None else torch.zeros_like(x) for x in flat[:4]]
    torch.autograd.backward(list(s[:4]), ups)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    grads[CAMERA] = g_cam + (cam.grad if cam.grad is not None else 0.0)
    return {"loss": loss.detach(), "grads": grads, "xys": ups[0], "radii": s.radii}


def camera_adam(adjust, grad, mu, nu, count: int, step: int):
    """One Adam step of the camera group; returns (adjust, mu, nu)."""
    count_f = torch.tensor(float(count), device=adjust.device)
    mu = rtrain.B1 * mu + (1 - rtrain.B1) * grad
    nu = rtrain.B2 * nu + (1 - rtrain.B2) * grad * grad
    upd = camera_lr(step).to(adjust.device) * (mu / (1.0 - rtrain.B1 ** count_f)) / (
        torch.sqrt(nu / (1.0 - rtrain.B2 ** count_f)) + rtrain.EPS)
    return adjust - upd, mu, nu


@torch.no_grad()
def refine(params: Dict[str, torch.Tensor], mu, nu, stats: Dict[str, torch.Tensor],
           step: int, generator: torch.Generator, num_train: int, image_size: int,
           ar: Arith = Arith(), fault: str = "") -> Dict[str, torch.Tensor]:
    """The refine at the state's ``step``, in place on ``params`` (with
    ``alive``) and on the moments (none when ``mu`` is None); returns the
    lanes it wrote, each one's parent lane and sample (0, 1 split, 2
    copy), and its counts."""
    if step % RESET_EVERY == rtrain.REFINE_EVERY and WARMUP < step < STOP_SPLIT_AT:
        raise ValueError(f"step {step}: the refine resets opacities, which this "
                         "reference does not follow")
    alive = params["alive"]
    c = alive.numel()
    dev = alive.device
    warm = step <= WARMUP
    densify = (not warm and step < STOP_SPLIT_AT
               and step % RESET_EVERY > num_train + rtrain.REFINE_EVERY)
    cull_only = not warm and step >= STOP_SPLIT_AT
    avg = stats["grad"] / torch.clamp(stats["vis"], min=1.0) * 0.5 * image_size
    high = (avg > DENSIFY_GRAD) & alive
    scale = torch.exp(params["scales"])
    smax = scale.amax(-1)
    big = smax > DENSIFY_SIZE
    big_screen = (stats["max2d"] > SPLIT_SCREEN) & (step < STOP_SCREEN_SIZE_AT)
    grow = densify and fault != "densify_skipped"
    splits = (big | big_screen) & high & grow
    dups = ~big & high & grow
    noise = torch.randn((SPLIT_SAMPLES, c, 3), generator=generator, device=dev)
    split_scale = torch.log(torch.clamp(scale / 1.6, min=1e-30))
    op = params["opacities"][:, 0]
    past_reset = step > RESET_EVERY
    low = (op if fault == "cull_logit" else torch.sigmoid(op)) < rtrain.CULL_ALPHA
    too_big = (smax > rtrain.CULL_SCALE) | (
        (stats["max2d"] > CULL_SCREEN) & (step < STOP_SCREEN_SIZE_AT))
    cull = (low | (past_reset & too_big)) & alive
    if fault == "cull_none":
        cull = torch.zeros_like(cull)
    cull = (cull & (densify or cull_only)) | splits
    op_ok = torch.sigmoid(op) >= rtrain.CULL_ALPHA
    split_ok = splits & op_ok & ~(past_reset & (torch.exp(split_scale).amax(-1)
                                                > rtrain.CULL_SCALE))
    dup_ok = dups & op_ok & ~(past_reset & (smax > rtrain.CULL_SCALE))
    free = torch.nonzero(~(alive & ~cull))[:, 0]
    a, b = torch.nonzero(split_ok)[:, 0], torch.nonzero(dup_ok)[:, 0]
    parent = torch.cat([a] * SPLIT_SAMPLES + [b])
    sample = torch.cat([torch.full_like(a, k) for k in range(SPLIT_SAMPLES)]
                       + [torch.full_like(b, SPLIT_SAMPLES)])
    n = min(parent.numel(), free.numel())
    slot, parent, sample = free[:n], parent[:n], sample[:n]
    q = params["quats"][parent]
    rot = splat._quat_rot(q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                                          min=1e-12))
    split = sample < SPLIT_SAMPLES
    offset = ar.matmul(rot, (scale[parent] * noise[sample.clamp(max=SPLIT_SAMPLES - 1),
                                                   parent])[..., None])[..., 0]
    child = {k: params[k][parent] for k in GROUPS}
    child["means"] = torch.where(split[:, None], child["means"] + offset,
                                 child["means"])
    child["scales"] = torch.where(split[:, None], split_scale[parent], child["scales"])
    out_alive = alive & ~cull
    out_alive[slot] = True
    params["alive"] = out_alive
    for k in GROUPS:
        v = params[k].clone()
        v[slot] = child[k]
        params[k] = v
        for m in (mu, nu) if mu is not None else ():
            m[k] = m[k].clone()
            m[k][slot] = 0.0
    return {"slot": slot, "parent": parent, "sample": sample,
            "split": int(splits.sum()), "dup": int(dups.sum()),
            "cull": int(cull.sum())}


def run_steps(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
              camera: Dict, views: Sequence[splat.View], indices: Sequence[int],
              targets: Sequence[torch.Tensor], depths: Sequence[torch.Tensor],
              generator: torch.Generator, first_step: int, sh_degree: int,
              bands: int, num_train: int, ar: Arith, fault: str = "",
              moments=None, count: int = 0) -> Dict:
    """Train ``len(views)`` steps from ``params`` at the state's step
    ``first_step`` with the densify statistics ``stats`` (``grad``,
    ``vis``, ``max2d``), the camera group ``camera`` (``adjust``, ``mu``,
    ``nu``, ``count``), the scene's Adam moments ``moments = (mu, nu)``
    after ``count`` steps (fresh when None), drawing each step's background
    and patch origins and each refine's normal draws from ``generator``,
    and refining after each step that ends a refine period, in float32
    with TF32 off (``ar`` may emulate the TF32 control). Returns the
    losses, the first step's gradient norms by group, the change of every
    group over the steps before any refine, and after a refine the state
    it started from (``pre_refine``), what it wrote, the alive lanes and
    the parameters."""
    with strict_f32():
        return _run_steps(params, stats, camera, views, indices, targets, depths,
                          generator, first_step, sh_degree, bands, num_train, ar,
                          fault, moments, count)


def _run_steps(params, stats, camera, views, indices, targets, depths, generator,
               first_step, sh_degree, bands, num_train, ar, fault, moments, count):
    dev = params["alive"].device
    start = {k: params[k].clone() for k in GROUPS}
    start_adjust = camera["adjust"].clone()
    params, stats = dict(params), dict(stats)
    if moments is None:
        mu = {k: torch.zeros_like(params[k]) for k in GROUPS}
        nu = {k: torch.zeros_like(params[k]) for k in GROUPS}
    else:
        mu = {k: moments[0][k].clone() for k in GROUPS}
        nu = {k: moments[1][k].clone() for k in GROUPS}
    adjust, cmu, cnu = camera["adjust"].clone(), camera["mu"].clone(), camera["nu"].clone()
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    out: Dict = {}
    for i, (view, index, tgt, depth) in enumerate(zip(views, indices, targets, depths)):
        step = first_step + i
        bg = torch.rand(3, generator=generator, device=dev)
        origins = patch_origins(generator, view.height, view.width, dev)
        gt = tgt.to(torch.float32) / torch.full((), 255.0, device=dev)
        a = gt[..., 3:4]
        gt = a * gt[..., :3] + (1.0 - a) * bg
        r = gradients(params, adjust, index, view, gt, depth, bg, origins, step,
                      sh_degree, bands, ar, fault)
        losses.append(float(r["loss"]))
        g = r["grads"]
        if i == 0:
            alive = params["alive"]
            grad_norms = {k: float(torch.linalg.norm(torch.where(
                alive.reshape(alive.shape + (1,) * (g[k].ndim - 1)), g[k], 0.0
            ).double())) for k in GROUPS}
            grad_norms[CAMERA] = float(torch.linalg.norm(g[CAMERA].double()))
        xy = r["xys"]
        stats["grad"] = stats["grad"] + torch.sqrt(xy[:, 0] * xy[:, 0] + xy[:, 1] * xy[:, 1])
        stats["vis"] = stats["vis"] + (r["radii"] > 0).to(torch.float32)
        stats["max2d"] = torch.maximum(stats["max2d"], r["radii"] / max(view.height, view.width))
        rtrain.adam(params, g, mu, nu, count + i + 1, step, params["alive"])
        if fault != "camera_frozen":
            adjust, cmu, cnu = camera_adam(adjust, g[CAMERA], cmu, cnu,
                                           camera["count"] + i + 1, step)
        del r, g
        if (step + 1) % rtrain.REFINE_EVERY == 0:
            if "change_norms" not in out:
                out["change_norms"] = _change(params, start, adjust, start_adjust)
            out["pre_refine"] = {
                "params": {k: params[k] for k in GROUPS}, "alive": params["alive"],
                "stats": stats, "step": step + 1, "generator": generator.get_state()}
            out["refine"] = refine(params, mu, nu, stats, step + 1, generator,
                                   num_train, max(view.height, view.width), ar, fault)
            stats = {k: torch.zeros_like(v) for k, v in stats.items()}
    if "change_norms" not in out:
        out["change_norms"] = _change(params, start, adjust, start_adjust)
    out.update(losses=losses, grad_norms=grad_norms, alive=params["alive"],
               params={k: params[k] for k in GROUPS})
    return out


def refine_from(pre: Dict, num_train: int, image_size: int,
                ar: Arith = Arith()) -> Dict:
    """:func:`refine` of the state ``pre`` (a run's ``pre_refine``: the
    parameters, ``alive``, the statistics, the step and the generator's
    state before the refine), on copies: the alive lanes and parameters
    after it and the lanes it wrote."""
    params = {k: v.clone() for k, v in pre["params"].items()}
    params["alive"] = pre["alive"].clone()
    gen = torch.Generator(device=params["alive"].device)
    gen.set_state(pre["generator"])
    with strict_f32():
        info = refine(params, None, None, pre["stats"], pre["step"], gen, num_train,
                      image_size, ar)
    return {"alive": params.pop("alive"), "params": params, "slot": info["slot"]}


def _change(params, start, adjust, start_adjust) -> Dict[str, float]:
    out = {k: float(torch.linalg.norm((params[k] - start[k]).double())) for k in GROUPS}
    out[CAMERA] = float(torch.linalg.norm((adjust - start_adjust).double()))
    return out
