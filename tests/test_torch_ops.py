"""gstk_torch math, SH, cameras, projection and the K3 plain twin against
gstk_tpu on identical numpy inputs (CPU).

Tolerances: math, SH and cameras rtol 1e-5 / atol 1e-6 (same f32 formulas,
different libraries); projection as tests/test_projection.py holds gstk_tpu
to the numpy oracle; segment broadcast exact (integer arithmetic mod 2**32).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core import cameras as jcam
from gstk_tpu.ops import oracle
from gstk_tpu.ops import projection as jproj
from gstk_tpu.ops import sh as jsh
from gstk_tpu.ops.segment_kernel import segment_broadcast as jax_segment_broadcast
from gstk_tpu.utils import math as jmath
from gstk_torch.core import cameras as tcam
from gstk_torch.ops import projection as tproj
from gstk_torch.ops import sh as tsh
from gstk_torch.ops.segment_kernel import segment_broadcast, segment_broadcast_plain
from gstk_torch.utils import math as tmath

from tests._scenes import make_camera, make_gaussians

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _c2w(rng):
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    R = oracle.quat_to_rotmat_np(q)
    return np.concatenate([R, rng.normal(size=(3, 1))], 1).astype(np.float32)


def test_math_matches(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    qn = np.asarray(jmath.normalize(jnp.asarray(q)))
    np.testing.assert_allclose(_np(tmath.normalize(_t(q))), qn, **TOL)
    np.testing.assert_allclose(
        _np(tmath.quat_to_rotmat(_t(qn))),
        np.asarray(jmath.quat_to_rotmat(jnp.asarray(qn))), **TOL,
    )
    rgb = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tmath.rgb_to_sh(_t(rgb))), np.asarray(jmath.rgb_to_sh(jnp.asarray(rgb))), **TOL
    )
    np.testing.assert_allclose(
        _np(tmath.sh_to_rgb(_t(rgb))), np.asarray(jmath.sh_to_rgb(jnp.asarray(rgb))), **TOL
    )
    np.testing.assert_allclose(
        _np(tmath.projection_matrix(0.001, 1000.0, 0.9, 0.7)),
        np.asarray(jmath.projection_matrix(0.001, 1000.0, 0.9, 0.7)), **TOL,
    )
    quats = tmath.random_quats(torch.Generator().manual_seed(0), 256)
    np.testing.assert_allclose(_np(torch.linalg.norm(quats, dim=-1)), 1.0, **TOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_matches(rng, degree):
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(200, 25, 3)).astype(np.float32)
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)
    np.testing.assert_allclose(
        _np(tsh.spherical_harmonics(degree, _t(dirs), _t(coeffs))),
        np.asarray(jsh.spherical_harmonics(degree, jnp.asarray(dirs), jnp.asarray(coeffs))),
        rtol=1e-5, atol=1e-5,  # sums of up to 25 terms of size ~3
    )


def test_cameras_match(rng):
    c2w = _c2w(rng)
    np.testing.assert_allclose(
        _np(tcam.view_matrix(_t(c2w))), np.asarray(jcam.view_matrix(jnp.asarray(c2w))), **TOL
    )
    jc = jcam.Camera(fx=jnp.float32(70.0), fy=jnp.float32(65.0), cx=jnp.float32(32.0),
                     cy=jnp.float32(24.0), c2w=jnp.asarray(c2w))
    tc = tcam.Camera.create(70.0, 65.0, 32.0, 24.0, c2w, device="cpu")
    for a, b in zip(tcam.camera_matrices(tc, 48, 64), jcam.camera_matrices(jc, 48, 64)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def _project_all(rng, n=400):
    cam = make_camera()
    means, scales, quats, colors, opac = make_gaussians(rng, n)
    means[::9, 2] *= -1.0  # some behind the camera
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["img_h"], cam["img_w"])
    ref = oracle.project_gaussians_np(
        means, scales, 1.0, quats, cam["viewmat"], cam["fullmat"], *args
    )
    jout = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats),
        jnp.asarray(cam["viewmat"]), jnp.asarray(cam["fullmat"]), *args,
    )
    tout = tproj.project_gaussians(
        _t(means), _t(scales), 1.0, _t(quats), _t(cam["viewmat"]),
        _t(cam["fullmat"]), *[torch.tensor(a, dtype=torch.float32) for a in args[:4]],
        cam["img_h"], cam["img_w"],
    )
    return ref, {k: np.asarray(v) for k, v in jout._asdict().items()}, {
        k: _np(v) for k, v in tout._asdict().items()
    }, opac


def test_projection_matches_jax_and_oracle(rng):
    ref, jout, tout, _ = _project_all(rng)
    # integer outputs come from floats, so one ulp may flip a radius or a
    # tile count: allow at most 1% of Gaussians to differ
    for name in ("mask", "radii", "num_tiles_hit"):
        for other in (jout[name], ref[name]):
            assert np.mean(tout[name] != other) <= 0.01, name
    m = tout["mask"] & jout["mask"] & ref["mask"]
    assert m.sum() > 100
    float_tol = dict(xys=(1e-4, 1e-4), depths=(1e-5, 1e-6), conics=(1e-4, 1e-5),
                     compensation=(1e-4, 1e-5))
    for name, (rtol, atol) in float_tol.items():
        for other in (jout[name], ref[name]):
            np.testing.assert_allclose(tout[name][m], other[m], rtol=rtol, atol=atol)
    np.testing.assert_allclose(tout["cov3d"][m], jout["cov3d"][m], rtol=1e-5, atol=1e-7)


def test_tight_extents_and_tile_bbox_match(rng):
    _, jout, tout, opac = _project_all(rng)
    ext_j = np.asarray(jproj.tight_extents(
        jnp.asarray(jout["conics"]), jnp.asarray(opac), jnp.asarray(jout["radii"])
    ))
    ext_t = _np(tproj.tight_extents(_t(jout["conics"]), _t(opac), _t(jout["radii"])))
    np.testing.assert_allclose(ext_t, ext_j, rtol=1e-5, atol=1e-6)
    for a, b in zip(
        tproj.tile_bbox(_t(jout["xys"]), _t(ext_j), (4, 3), 16),
        jproj.tile_bbox(jnp.asarray(jout["xys"]), jnp.asarray(ext_j), (4, 3), 16),
    ):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def _seg_case(rng, case):
    n, length = 700, 4096
    if case == "wrap":
        b = np.sort(rng.integers(0, length + 50, n))
        ds = [rng.integers(-(2**31), 2**31, n) for _ in range(3)]
    elif case == "repeats_and_zero_counts":
        counts = rng.integers(0, 4, n)
        counts[rng.random(n) < 0.3] = 0
        b = np.cumsum(counts)
        ds = [np.ones(n), rng.integers(-5, 5, n)]
    elif case == "all_past_length":
        b = np.full(n, length + 7)
        ds = [np.arange(n)]
    else:  # "tail_past_length": the overflow case of binning
        b = np.cumsum(rng.integers(0, 20, n))
        length = int(b[n // 2])
        ds = [np.ones(n), rng.integers(-(2**31), 2**31, n), np.arange(n)]
    return b.astype(np.int32), [d.astype(np.int64).astype(np.int32) for d in ds], length


@pytest.mark.parametrize(
    "case", ["wrap", "repeats_and_zero_counts", "all_past_length", "tail_past_length"]
)
def test_segment_broadcast_plain_matches_jax(rng, case):
    b, ds, length = _seg_case(rng, case)
    ref = jax_segment_broadcast(
        jnp.asarray(b), [jnp.asarray(d) for d in ds], length, interpret=True
    )
    got = segment_broadcast_plain(_t(b), [_t(d) for d in ds], length)
    before = segment_broadcast.launches
    via_wrapper = segment_broadcast(_t(b), [_t(d) for d in ds], length)
    for g, w, r in zip(got, via_wrapper, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), np.asarray(r))
        np.testing.assert_array_equal(_np(w), np.asarray(r))
    assert segment_broadcast.launches == before  # CPU tensors: no kernel


def test_port_imports_no_jax():
    """Every gstk_torch module and chip_smoke.py import without jax or
    gstk_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gstk_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(gstk_torch.__path__, 'gstk_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'gstk_tpu' or k.startswith('gstk_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
