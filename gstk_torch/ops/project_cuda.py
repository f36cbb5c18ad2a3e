"""Projection and SH colour of every Gaussian in one CUDA launch a view, and
their backward in one launch (``csrc/project_fwd.cu``,
``csrc/project_bwd.cu``).

The plain twin is :func:`gstk_torch.models.vanilla.splat_inputs_plain` (over
``ops/projection.py`` and ``ops/sh.py``). The kernels repeat its f32
operations in its order, so radii, tile counts and masks come out of the
same roundings, and the backward follows its autograd: ties of
``torch.minimum``/``torch.maximum`` split the gradient, the ``torch.where``
guards pass zero. :func:`gstk_torch.models.vanilla.splat_inputs` takes this
path for CUDA tensors under the ``"auto"`` backend.

The kernels read the scene's parameters where they lie (no ``cat`` of the SH
coefficients) and the view as one (35,) float32 tensor
(:func:`view_params`). The backward saves only the raw parameters and
recomputes each lane's projection from them. Where the view's matrices
require grad (camera optimisation), it also returns their gradient, summed
over the lanes in a fixed order. The camera position takes none, as in the
plain path (its view directions are detached); :func:`view_params` refuses
intrinsics that require grad.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from gstk_torch import _build
from gstk_torch.core.gaussians import PARAM_NAMES

VIEW_FLOATS = 35  # viewmat rows 0-2, fullmat, fx, fy, cx, cy, camera position
MAX_SH_DEGREE = 4
OUTPUT_NAMES = ("xys", "depths", "radii", "conics", "num_tiles_hit", "colors",
                "opacities")

# n, rest_rows, sh_degree, sigmoid_colors, antialiased, width, height, block
_SCALARS = [ctypes.c_int] * 8
# then 8 inputs, 7 outputs and the stream
_FWD_ARGTYPES = _SCALARS + [ctypes.c_void_p] * 16
# then 8 inputs, 5 cotangents, 6 gradients, the view's gradient and its
# partials, the partials' length and the stream
_BWD_ARGTYPES = (_SCALARS + [ctypes.c_void_p] * 21 + [ctypes.c_longlong,
                                                      ctypes.c_void_p])
# the backward's CTA (csrc/project_common.cuh kThreads) and the view terms
# it sums a CTA (csrc/project_bwd.cu kViewTerms)
LANES_PER_CTA = 128
VIEW_GRAD_TERMS = 24


class Setting(NamedTuple):
    """What the kernels take besides tensors."""

    img_height: int
    img_width: int
    block_width: int
    sh_degree: int  # the active degree, 0-4
    sigmoid_colors: bool  # colour = sigmoid(features_dc) (a model without SH)
    antialiased: bool  # opacity times the blur's compensation


def view_params(camera, viewmat: torch.Tensor, fullmat: torch.Tensor
                ) -> torch.Tensor:
    """The kernels' per-view constants, (35,) float32: viewmat rows 0-2,
    fullmat, fx, fy, cx, cy and the camera's position; differentiable in
    the two matrices only."""
    intrinsics = (camera.fx, camera.fy, camera.cx, camera.cy)
    if any(torch.is_tensor(x) and x.requires_grad for x in intrinsics):
        raise ValueError("project_cuda: the kernels differentiate the view's "
                         "matrices, not fx, fy, cx or cy")
    return torch.cat([
        viewmat[:3].reshape(-1), fullmat.reshape(-1),
        *(x.detach().reshape(1) for x in intrinsics),
        camera.position.detach(),
    ])


def _check(params: Sequence[torch.Tensor], alive, view, setting: Setting,
           name: str) -> None:
    means, scales, quats, features_dc, features_rest, opacities = params
    n = means.shape[0]
    shapes_ok = (
        means.shape == (n, 3) and scales.shape == (n, 3)
        and quats.shape == (n, 4) and opacities.shape == (n, 1)
        and features_dc.shape == (n, 3) and features_rest.ndim == 3
        and features_rest.shape[0] == n and features_rest.shape[2] == 3
        and alive.shape == (n,) and view.shape == (VIEW_FLOATS,)
    )
    if not shapes_ok:
        raise ValueError(
            f"{name}: expected means (N,3), scales (N,3), quats (N,4), "
            "opacities (N,1), features_dc (N,3), features_rest (N,K-1,3), "
            f"alive (N,), view ({VIEW_FLOATS},); got "
            + ", ".join(str(tuple(x.shape)) for x in (*params, alive, view))
        )
    rows = features_rest.shape[1]
    degree = setting.sh_degree
    if (not 0 <= degree <= MAX_SH_DEGREE or (degree + 1) ** 2 - 1 > rows
            or rows > (MAX_SH_DEGREE + 1) ** 2 - 1
            or (setting.sigmoid_colors and degree != 0)):
        raise ValueError(
            f"{name}: takes sh_degree 0-{MAX_SH_DEGREE} (0 with sigmoid "
            f"colours) and at most {(MAX_SH_DEGREE + 1) ** 2 - 1} rest rows, "
            f"as many as the degree needs; got sh_degree {degree}, "
            f"features_rest {tuple(features_rest.shape)}"
        )
    if setting.block_width <= 0:
        raise ValueError(f"{name}: block_width {setting.block_width}")
    for x in (*params, view):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: float32 expected, got {x.dtype}")
    if alive.dtype != torch.bool:
        raise ValueError(f"{name}: alive must be bool, got {alive.dtype}")
    for x in (*params, alive, view):
        if not x.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors expected")
    devices = {x.device for x in (*params, alive, view)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors on one device; got "
                         f"{devices}")


def _scalars(n: int, rows: int, s: Setting):
    return (n, rows, s.sh_degree, int(s.sigmoid_colors), int(s.antialiased),
            s.img_width, s.img_height, s.block_width)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def project_fwd(params: Sequence[torch.Tensor], alive: torch.Tensor,
                view: torch.Tensor, setting: Setting) -> Tuple[torch.Tensor, ...]:
    """One launch of the forward kernel: ``params`` are the scene's
    parameters in ``PARAM_NAMES``' order, ``alive`` the lanes to render.
    Returns the tensors of :data:`OUTPUT_NAMES`, as ``splat_inputs_plain``
    returns them."""
    _check(params, alive, view, setting, "project_fwd")
    means, rest = params[0], params[4]
    n = means.shape[0]
    f32 = dict(dtype=torch.float32, device=means.device)
    i32 = dict(dtype=torch.int32, device=means.device)
    out = (torch.empty((n, 2), **f32), torch.empty((n,), **f32),
           torch.empty((n,), **i32), torch.empty((n, 3), **f32),
           torch.empty((n,), **i32), torch.empty((n, 4), **f32),
           torch.empty((n,), **f32))
    if n == 0:
        return out
    fn = _build.kernel_function("gstk_project_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(means.device):
        err = fn(*_scalars(n, rest.shape[1], setting),
                 *(x.data_ptr() for x in (*params, alive, view, *out)),
                 torch.cuda.current_stream(means.device).cuda_stream)
    _build.check("project_fwd", err)
    _build.count_launch(project_fwd)
    return out


project_fwd.launches = 0


def project_bwd(params: Sequence[torch.Tensor], alive: torch.Tensor,
                view: torch.Tensor, cotangents: Sequence[Optional[torch.Tensor]],
                setting: Setting, view_grad: bool = False
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """One launch of the backward kernel (and, with ``view_grad``, one of
    the sum of its view terms): the forward's inputs and the cotangents of
    (xys, depths, conics, colors, opacities), None for zero. Returns the
    gradients of ``params`` and then the view's, (35,) with the entries of
    viewmat rows 0-2 and fullmat rows 0, 1 and 3 filled and zeros
    elsewhere, or None without ``view_grad``."""
    _check(params, alive, view, setting, "project_bwd")
    means, rest = params[0], params[4]
    n = means.shape[0]
    shapes = ((n, 2), (n,), (n, 3), (n, 4), (n,))
    cot = []
    for g, shape in zip(cotangents, shapes):
        if g is not None and (tuple(g.shape) != shape
                              or g.dtype != torch.float32
                              or g.device != means.device):
            raise ValueError(f"project_bwd: cotangent {tuple(g.shape)} "
                             f"{g.dtype} on {g.device}, expected float32 "
                             f"{shape} on {means.device}")
        cot.append(None if g is None else g.contiguous())
    grads = [torch.empty_like(x) for x in params]
    if setting.sh_degree == 0:  # the kernel writes no features_rest rows
        grads[4] = torch.zeros_like(rest)
    g_view = torch.zeros_like(view) if view_grad else None
    if n == 0:
        return (*grads, g_view)
    ctas = -(-n // LANES_PER_CTA)
    partials = (torch.empty(VIEW_GRAD_TERMS * ctas, dtype=torch.float32,
                            device=means.device) if view_grad else None)
    fn = _build.kernel_function("gstk_project_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(means.device):
        err = fn(*_scalars(n, rest.shape[1], setting),
                 *(x.data_ptr() for x in (*params, alive, view)),
                 *(_ptr(g) for g in cot), *(g.data_ptr() for g in grads),
                 _ptr(g_view), _ptr(partials),
                 0 if partials is None else partials.numel(),
                 torch.cuda.current_stream(means.device).cuda_stream)
    _build.check("project_bwd", err)
    _build.count_launch(project_bwd)
    if view_grad:
        _build.count_launch(project_bwd, "view_grad_launches")
    return (*grads, g_view)


project_bwd.launches = 0
# the backward's launches with view gradients, each also launching
# view_grad_sum_kernel (camera optimisation)
project_bwd.view_grad_launches = 0


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means, scales, quats, features_dc, features_rest,
                opacities, alive, view, setting):
        params = (means, scales, quats, features_dc, features_rest, opacities)
        out = project_fwd(params, alive, view, setting)
        ctx.mark_non_differentiable(out[2], out[4])  # radii, tile counts
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*params, alive, view)
        ctx.setting = setting
        return out

    @staticmethod
    def backward(ctx, g_xys, g_depths, _g_radii, g_conics, _g_tiles, g_colors,
                 g_opacities):
        *params, alive, view = ctx.saved_tensors
        *grads, g_view = project_bwd(
            params, alive, view,
            (g_xys, g_depths, g_conics, g_colors, g_opacities), ctx.setting,
            view_grad=ctx.needs_input_grad[7])
        return (*grads, None, g_view, None)


def project_splats(scene, alive: torch.Tensor, view: torch.Tensor,
                   setting: Setting) -> Dict[str, torch.Tensor]:
    """:func:`gstk_torch.models.vanilla.splat_inputs`' dict through the two
    kernels, differentiable in the scene's parameters and in ``view``
    (:func:`view_params`)."""
    out = _Project.apply(*(getattr(scene, k) for k in PARAM_NAMES), alive,
                         view, setting)
    return dict(zip(OUTPUT_NAMES, out))
