"""Gaussian splat PLY export and import in the standard attribute layout
(port of ``gstk_tpu/exporter/gaussian_ply.py``).

Binary little-endian PLY with x, y, z, nx, ny, nz, f_dc_{0..2},
f_rest_{...}, opacity, scale_{0..2}, rot_{0..3}; f_rest flattened
channel-major ((N, K-1, 3) -> (N, 3*(K-1)) via transpose), raw parameter
space (log scales, logit opacities, unnormalized quats): the interchange
format 3DGS viewers read. Only alive lanes are written, so the file is
byte for byte gstk_tpu's for the same scene.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gstk_torch import DeviceLike
from gstk_torch.core.gaussians import GaussianScene, scene_from_numpy, scene_to_numpy
from gstk_torch.utils.io import read_ply, write_ply


def export_gaussian_ply(path, scene: GaussianScene) -> int:
    """Write the alive Gaussians to a PLY. Returns the number written."""
    arrays = scene_to_numpy(scene)
    alive = arrays["alive"]
    xyz = arrays["means"][alive].astype(np.float32)
    n = xyz.shape[0]
    f_dc = arrays["features_dc"][alive].astype(np.float32)
    rest = arrays["features_rest"][alive].astype(np.float32)
    f_rest = rest.transpose(0, 2, 1).reshape(n, -1)
    opac = arrays["opacities"][alive].astype(np.float32)[:, 0]
    scales = arrays["scales"][alive].astype(np.float32)
    quats = arrays["quats"][alive].astype(np.float32)

    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    zeros = np.zeros(n, np.float32)
    props.update({"nx": zeros, "ny": zeros.copy(), "nz": zeros.copy()})
    for i in range(3):
        props[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i]
    props["opacity"] = opac
    for i in range(3):
        props[f"scale_{i}"] = scales[:, i]
    for i in range(4):
        props[f"rot_{i}"] = quats[:, i]
    write_ply(Path(path), {"vertex": props})
    return n


def load_gaussian_ply(path, device: DeviceLike = None) -> GaussianScene:
    """Read a splat PLY back into a GaussianScene on ``device`` (default
    ``cuda``), capacity == count, every lane alive."""
    v = read_ply(path)["vertex"]
    n = len(v)
    names = v.dtype.names
    n_rest = sum(1 for p in names if p.startswith("f_rest_"))
    k_rest = n_rest // 3
    stack = lambda keys: np.stack([v[k] for k in keys], axis=-1).astype(
        np.float32)
    if n_rest:
        f_rest = stack([f"f_rest_{i}" for i in range(n_rest)])
        f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    return scene_from_numpy(
        {
            "means": stack(["x", "y", "z"]),
            "scales": stack([f"scale_{i}" for i in range(3)]),
            "quats": stack([f"rot_{i}" for i in range(4)]),
            "features_dc": stack([f"f_dc_{i}" for i in range(3)]),
            "features_rest": f_rest,
            "opacities": v["opacity"].astype(np.float32)[:, None],
            "alive": np.ones((n,), bool),
        },
        device,
    )
