from gstk_torch.core.cameras import Camera, camera_matrices
from gstk_torch.core.gaussians import GaussianScene

__all__ = ["Camera", "camera_matrices", "GaussianScene"]
