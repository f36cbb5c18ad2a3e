"""viser-based live viewer, used when the ``viser`` package is importable
(port of ``gstk_tpu/viewer/viser_viewer.py``).

Mirrors the reference ``Viewer`` (``gs_toolkit/viewer/viewer.py:42-572``):
a viser server showing the training scene as a Gaussian-splat cloud. Where
viser is not installed, :mod:`gstk_torch.viewer.http_viewer` provides the
dependency-free viewer; :func:`make_viewer` picks between the two. viser
is imported only by :class:`ViserViewer`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gstk_torch import DeviceLike


def viser_available() -> bool:
    try:
        import viser  # noqa: F401

        return True
    except ImportError:
        return False


class ViserViewer:
    def __init__(self, model_config, raster_config, port: int = 7007):
        import viser

        self.server = viser.ViserServer(port=port)
        self.model_config = model_config
        self.raster_config = raster_config
        self._handle = None

    def start(self):
        return self

    def stop(self):
        self.server.stop()

    def update_scene(self, scene, stats: Optional[dict] = None):
        from gstk_torch.core.gaussians import scene_to_numpy
        from gstk_torch.utils.math import SH_C0

        arrays = scene_to_numpy(scene)
        alive = arrays["alive"]
        centers = arrays["means"][alive]
        rgbs = np.clip(arrays["features_dc"][alive] * SH_C0 + 0.5, 0, 1)
        opac = 1.0 / (1.0 + np.exp(-arrays["opacities"][alive, 0]))
        scales = np.exp(arrays["scales"][alive])
        quats = arrays["quats"][alive]
        quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
        covs = _quat_scale_to_cov(quats, scales)
        if hasattr(self.server.scene, "add_gaussian_splats"):
            self._handle = self.server.scene.add_gaussian_splats(
                "/gaussians",
                centers=centers,
                rgbs=rgbs,
                opacities=opac[:, None],
                covariances=covs,
            )
        else:  # older viser: point cloud fallback
            self._handle = self.server.scene.add_point_cloud(
                "/gaussians", points=centers,
                colors=(rgbs * 255).astype(np.uint8), point_size=0.01,
            )


def _quat_scale_to_cov(quats: np.ndarray, scales: np.ndarray) -> np.ndarray:
    w, x, y, z = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)
    M = R * scales[:, None, :]
    return M @ M.transpose(0, 2, 1)


def make_viewer(model_config, raster_config, port: int = 7007,
                run_info=None, device: DeviceLike = None,
                host: str = "0.0.0.0"):
    """viser when available, the stdlib HTTP viewer otherwise.

    Both render with ``raster_config`` as given. gstk_tpu swaps in its TPU
    render knobs here (``kernel_precision="high"``, a transposed attribute
    table, forward-only); the port has one exact compositing kernel, so
    there is nothing to swap."""
    if viser_available():
        return ViserViewer(model_config, raster_config, port=port)
    from gstk_torch.viewer.http_viewer import TrainingViewer

    return TrainingViewer(model_config, raster_config, port=port,
                          run_info=run_info, host=host, device=device)
